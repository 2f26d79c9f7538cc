"""Copies of program code that the benchmark must keep fixed: the dataset
writers, the kernels' operation and byte counts and the CUDA timers. Each
file names the commit it was copied from."""
