"""Kernel K2, the chunked closed-loop battery collect: the port's plain
version against the JAX package's Pallas kernel run in interpret mode,
its packing against ``prepare_battery_collect``'s, and, on a CUDA card,
the hand-written kernel against its plain version.

Tolerances. Against JAX: 1e-5 relative to each output's scale. XLA:CPU
contracts ``a + b * c`` into fused multiply-adds (``energy_init + e *
rt``) where the port rounds twice; the last-bit differences accumulate
through the K-step SOC recurrence. On the card: the kernel is built with
``-fmad=false`` and IEEE division and square root, so it rounds every
operation as the plain version does; it is held to 1e-6 relative and is
expected to be bit-equal.

The card's machine has no JAX: the JAX side is imported inside the tests
that compare with it, and the ``gpu`` test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_collect.py``."""

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.ops import collect as k2
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

K, B = 24, 5
OUTPUTS = ("reward", "soc", "eff", "deg")


def assert_close(ours, ref, name, rtol=1e-5):
    as_np = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    ours, ref = as_np(ours), as_np(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=3)


def random_streams(prep, D, n_steps, seed=0):
    """Seeded per-district (K, D, B) action, load and solar streams and a
    (D, B) battery state around the district's own parameters."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    cap = prep.bparams[0].cpu().numpy()
    streams = [f(-1.0, 1.0, (n_steps, D, B)), f(0.2, 3.0, (n_steps, D, B)),
               f(0.0, 3.0, (n_steps, D, B))]
    state = [f(0.0, 1.0, (D, B)), f(0.85, 0.95, (D, B)), cap * f(0.9, 1.0, (D, B))]
    return streams, state


def torch_prep(dataset):
    cfg, params, _ = pack(compile_schema(dataset), device="cpu")
    return k2.prepare_battery_collect(cfg, params)


def test_prepare_matches_jax(dataset):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack
    from citylearn_tpu.ops.pallas_collect import prepare_battery_collect

    jcfg, jparams, _ = jax_pack(jax_compile(dataset))
    ref = prepare_battery_collect(jcfg, jparams)
    ours = torch_prep(dataset)
    rows = np.asarray(ref.bparams)[:, :B, 0]       # cap, nominal, loss, dod, clc, live
    np.testing.assert_array_equal(ours.bparams[[0, 1, 2, 4, 5]].numpy(), rows[:5])
    for a, b in zip(ours.curves, (ref.pec_x, ref.pec_y, ref.cpc_x, ref.cpc_y)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:, :B, 0])
    assert (ours.hours_ratio, ours.ratio) == (ref.hours_ratio, ref.ratio)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("first_chunk", [True, False])
def test_reference_matches_jax_interpret(dataset, D, first_chunk):
    import jax.numpy as jnp

    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack
    from citylearn_tpu.ops.pallas_collect import battery_collect_chunk, prepare_battery_collect

    jcfg, jparams, _ = jax_pack(jax_compile(dataset))
    prep = torch_prep(dataset)
    streams, state = random_streams(prep, D, K, seed=D + first_chunk)
    ours = k2.battery_collect_chunk(prep, *[torch.tensor(x) for x in streams + state],
                                    first_chunk=first_chunk)
    ref = battery_collect_chunk(prepare_battery_collect(jcfg, jparams),
                                *[jnp.asarray(x) for x in streams + state],
                                first_chunk=first_chunk, interpret=True)
    assert ours[0].shape == (K, D, B)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, b, name)
    # both battery branches run, and the districts' streams differ
    assert (streams[0] > 0).any() and (streams[0] < 0).any()
    assert not torch.equal(ours[1][0], ours[1][1])


def test_first_chunk_counts_the_first_step_again(dataset):
    """t == 0 triple-counts the load and double-counts the battery: the
    first reward differs between the two modes, the rest do not."""
    prep = torch_prep(dataset)
    streams, state = random_streams(prep, 4, 3)
    args = [torch.tensor(x) for x in streams + state]
    first = k2.battery_collect_chunk(prep, *args, first_chunk=True)
    later = k2.battery_collect_chunk(prep, *args, first_chunk=False)
    assert not torch.equal(first[0][0], later[0][0])
    for a, b in zip(first[1:], later[1:]):
        assert torch.equal(a, b)
    assert torch.equal(first[0][1:], later[0][1:])


def test_wrapper_rejects_other_devices(dataset):
    prep = torch_prep(dataset)
    streams, state = random_streams(prep, 2, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k2.battery_collect_chunk(prep, *[torch.tensor(x, device="meta") for x in streams + state],
                                 first_chunk=True)


@pytest.mark.gpu
@pytest.mark.parametrize("first_chunk", [True, False])
def test_cuda_kernel_matches_reference(dataset, first_chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    cfg, params, _ = pack(compile_schema(dataset), device="cuda")
    prep = k2.prepare_battery_collect(cfg, params)
    streams, state = random_streams(prep, 512, 64, seed=7)
    args = [torch.tensor(x, device="cuda") for x in streams + state]
    before = k2.battery_collect_chunk.launches
    ours = k2.battery_collect_chunk(prep, *args, first_chunk=first_chunk)
    torch.cuda.synchronize()
    assert k2.battery_collect_chunk.launches == before + 1
    ref = k2.battery_collect_chunk_reference(prep, *args, first_chunk=first_chunk)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, b, name, rtol=1e-6)
