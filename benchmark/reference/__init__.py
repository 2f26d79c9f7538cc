"""Plain PyTorch and NumPy references that decide ``correct``.

They read the dataset files that the benchmark writes and the seeded draws
that it hands the program, and work out again everything the program
derives from them. They import nothing of ``citylearn_tpu_torch``, of
``citylearn_tpu`` or of ``jax``, and run in float32 with TF32 off; the
control runs them with every matrix product rounded to TF32.
"""
