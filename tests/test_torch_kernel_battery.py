"""Kernel K1, the whole-episode battery+PV rollout, and the fast path
around it: the port's plain version against the JAX package's Pallas
kernel run in interpret mode; ``run_battery_episode`` and
``evaluate_scripted`` against the JAX package's; the dispatch of
``evaluate_districts`` to the kernel path; and, on a CUDA card, the
hand-written kernel against its plain version and the branch-free division
and square root its district pass runs against IEEE's.

Tolerances. Against JAX: 1e-5 relative to each output's scale. XLA:CPU
contracts ``a + b * c`` into fused multiply-adds (``energy_init + e *
rt``, ``cost + net * price``) where the port rounds twice; the last-bit
differences then accumulate through the SOC recurrence and the
episode sums. On the card: the kernel is built with ``-fmad=false`` and
IEEE division and square root, so it rounds every operation as the plain
PyTorch version does; it is held to 1e-6 relative on the per-step record
and the state and 1e-5 on the year-long sums at 512 districts and 5
knots, and bit-equal at 301 districts and 8 knots.

The card's machine has no JAX: the JAX side is imported inside the tests
that compare with it, and the ``gpu`` test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_battery.py``."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import evaluate_fast, rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.ops import _build
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

S, B = 168, 5
RBC = np.where(np.arange(1, 25) < 9, 0.091, -0.08).astype(np.float32)
OUTPUTS = ("reward", "cost", "emission", "soc", "eff", "deg", "record")


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def random_inputs(D, n_steps, seed=0):
    """Seeded K1 inputs in the port's layout: plan and series (S, B),
    bparams (8, B), knot-major curves (5, B), per-district state (D, B)."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    actions = f(-1.0, 1.0, (n_steps, B))
    series = [f(0.2, 3.0, (n_steps, B)), f(0.0, 3.0, (n_steps, B)),
              f(0.1, 0.6, (n_steps, B)), f(0.05, 0.5, (n_steps, B))]
    cap = f(2.0, 10.0, B)
    bparams = np.stack([cap, f(1.0, 5.0, B), f(0.0, 0.01, B), f(0.0, 1.0, B),
                        f(0.7, 1.0, B), f(1e-5, 1e-4, B), np.zeros(B, np.float32),
                        np.zeros(B, np.float32)])
    pec_x = np.tile(np.array([0, 0.3, 0.7, 0.8, 1], np.float32)[:, None], (1, B))
    pec_y = f(0.8, 0.95, (5, B))
    cpc_x = np.tile(np.array([0, 0.8, 1, 1, 1], np.float32)[:, None], (1, B))
    cpc_y = np.tile(np.array([1, 1, 0.2, 0.2, 0.2], np.float32)[:, None], (1, B))
    state = [f(0.0, 1.0, (D, B)), f(0.85, 0.95, (D, B)),
             np.broadcast_to(cap, (D, B)) * f(0.9, 1.0, (D, B))]
    return actions, series, bparams, [pec_x, pec_y, cpc_x, cpc_y], state


def as_torch(inputs, device):
    actions, series, bparams, curves, state = inputs
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=device)
    return t(actions), [t(x) for x in series], t(bparams), [t(x) for x in curves], \
        [t(x) for x in state]


def test_reference_matches_jax_interpret():
    import jax.numpy as jnp

    from citylearn_tpu.ops.pallas_battery import battery_episode as jax_battery_episode

    D = 256
    actions, series, bparams, curves, state = inputs = random_inputs(D, S)
    ours = k1.battery_episode(*as_torch(inputs, "cpu")[:4], *as_torch(inputs, "cpu")[4],
                              hours_ratio=1.0, ratio=1.0, record=True)
    # the JAX kernel's TPU layout: 128 lanes, 512-step chunks
    t_pad = 512
    lanes = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 128 - B)], constant_values=1.0)
    rows = lambda a: np.pad(a, [(0, t_pad - S), (0, 0)])
    ref = jax_battery_episode(
        jnp.asarray(rows(lanes(actions))), tuple(jnp.asarray(rows(lanes(x))) for x in series),
        jnp.asarray(lanes(bparams)), tuple(jnp.asarray(lanes(c)) for c in curves),
        *[jnp.asarray(lanes(x)) for x in state],
        n_steps=S, hours_ratio=1.0, ratio=1.0, n_knots=5, record=True, interpret=True)
    for name, a, b in zip(OUTPUTS, ours, ref):
        b = np.asarray(b)[..., :B]
        assert_close(a, b[:, :S] if name == "record" else b, name)
    # both branches and the first-step accounting are exercised
    rec = ours[6]
    assert (rec[1] > 0).any() and (rec[1] < 0).any()
    assert not torch.equal(ours[3][0], ours[3][1])


@pytest.fixture(scope="module")
def district(tmp_path_factory):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack

    path = write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=5)
    kw = dict(episode_time_steps=S + 1)
    return (pack(compile_schema(path, **kw), device="cpu")[:2],
            jax_pack(jax_compile(path, **kw))[:2])


@pytest.mark.parametrize("offset", [0, 16])
def test_run_battery_episode_matches_jax(district, offset):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = district
    assert rollout_fast.eligible(cfg)
    n = S - offset
    ours = rollout_fast.run_battery_episode(cfg, params, 3, RBC, n_steps=n,
                                            record_series=True, data_offset=offset,
                                            device="cpu")
    ref = jax_rollout_fast.run_battery_episode(jcfg, jparams, 256, RBC, n_steps=n,
                                               interpret=True, record_series=True,
                                               data_offset=offset)
    assert ours[0].shape == (3, B) and ours[6].shape == (3, n, B)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, np.asarray(b)[:3] if name != "record" else b, name)


@pytest.mark.parametrize("baseline", ["_without_storage", "_without_storage_and_pv"])
def test_evaluate_scripted_matches_jax(district, baseline):
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate_scripted

    (cfg, params), (jcfg, jparams) = district
    plan = np.tile(RBC[:, None], (1, B))
    plan[:, 2] = -plan[:, 2]
    ours, rec = evaluate_scripted(cfg, params, ScriptedPolicy({"electrical_storage": plan}),
                                  baseline_condition=baseline, return_series=True,
                                  device="cpu")
    ref, jrec = jax_evaluate_scripted(jcfg, jparams,
                                      JaxScriptedPolicy({"electrical_storage": plan}),
                                      baseline_condition=baseline, interpret=True,
                                      return_series=True)
    assert_close(rec, jrec, "record")
    assert set(ours) == set(ref)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)


def test_evaluate_districts_dispatches_fresh_states(district, monkeypatch):
    (cfg, params), _ = district
    calls = []
    real = evaluate_fast.evaluate_scripted
    monkeypatch.setattr(evaluate_fast, "evaluate_scripted",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    policy = ScriptedPolicy({"electrical_storage": RBC})
    states = batched_initial_states(cfg, params, 3, device="cpu")
    fast = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    assert fast["building|cost_total"].shape == (3, B)
    # a hand-modified state is not fresh: the stepped path serves it
    states.battery_soc[1] = 0.5
    stepped = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    for k in fast:
        np.testing.assert_allclose(stepped[k][0].numpy(), fast[k][0].numpy(), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    assert not np.allclose(stepped["building|cost_total"][1].numpy(),
                           fast["building|cost_total"][1].numpy())


def test_wrapper_rejects_other_devices():
    inputs = as_torch(random_inputs(2, 4), "meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k1.battery_episode(*inputs[:4], *inputs[4], hours_ratio=1.0, ratio=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("D,n_knots", [(512, 5), (301, 8)], ids=["5-knots", "D301-8-knots"])
def test_cuda_kernel_matches_reference(D, n_knots):
    """512 districts with 5 knots (the build with the knot count fixed), held
    to 1e-6 of scale on the record and state and 1e-5 on the sums; 301
    districts (no block of districts full) with 8 knots (the run-time
    build), bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    n_steps = 720
    actions, series, bparams, curves, state = as_torch(random_inputs(D, n_steps, seed=1), "cuda")
    curves = [torch.cat([c, c[-1:].expand(n_knots - 5, -1)]).contiguous() for c in curves]
    before = k1.battery_episode.launches
    ours = k1.battery_episode(actions, series, bparams, curves, *state,
                              hours_ratio=1.0, ratio=1.0, record=True)
    torch.cuda.synchronize()
    assert k1.battery_episode.launches == before + 1
    ref = k1.battery_episode_reference(actions, series, bparams, curves, *state,
                                       hours_ratio=1.0, ratio=1.0, record=True)
    for name, a, b in zip(OUTPUTS, ours, ref):
        if n_knots == 5:
            assert_close(a, b.cpu(), name, rtol=1e-5 if name in ("reward", "cost", "emission")
                         else 1e-6)
        else:
            assert torch.equal(a, b), name


# div_fast and sqrt_fast (csrc/battery_common.cuh) against `/` and sqrtf:
# every float for the square root, random operand pairs for the division
# (uniform exponents in and around the fast range, some zero numerators);
# counts the results the fast path gives as IEEE's that are not
FAST_CHECK = r"""
#include "battery_common.cuh"

__device__ unsigned long long mix(unsigned long long x) {
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

__global__ void check(unsigned long long n_pairs, unsigned long long* counts) {
    unsigned long long bad_sqrt = 0, fast_sqrt = 0, bad_div = 0, fast_div = 0;
    const unsigned long long stride = gridDim.x * blockDim.x;
    const unsigned long long start = blockIdx.x * blockDim.x + threadIdx.x;
    for (unsigned long long i = start; i < (1ull << 32); i += stride) {
        const float x = __int_as_float(static_cast<int>(i));
        bool slow = false;
        const float s = battery::sqrt_fast(x, slow);
        if (!slow) {
            ++fast_sqrt;
            if (__float_as_int(s) != __float_as_int(sqrtf(x))) ++bad_sqrt;
        }
    }
    for (unsigned long long i = start; i < n_pairs; i += stride) {
        const unsigned long long h = mix(i);
        // random mantissas and signs, exponents over the fast range and past
        // its edges: numerators 2^-107..2^107, divisors 2^-37..2^37
        const int ea = 20 + static_cast<int>((h >> 0) % 215), eb = 90 + static_cast<int>((h >> 8) % 75);
        const int sa = static_cast<int>((h >> 16) & 1), sb = static_cast<int>((h >> 17) & 1);
        const int ma = static_cast<int>((h >> 18) & 0x7fffff), mb = static_cast<int>((h >> 41) & 0x7fffff);
        float a = __int_as_float((sa << 31) | (ea << 23) | ma);
        const float b = __int_as_float((sb << 31) | (eb << 23) | mb);
        if ((h >> 64 - 6) == 0) a = sa ? -0.f : 0.f;
        bool slow = false;
        const float q = battery::div_fast(a, b, slow);
        if (!slow) {
            ++fast_div;
            if (__float_as_int(q) != __float_as_int(a / b)) ++bad_div;
        }
    }
    atomicAdd(counts + 0, fast_sqrt);
    atomicAdd(counts + 1, bad_sqrt);
    atomicAdd(counts + 2, fast_div);
    atomicAdd(counts + 3, bad_div);
}

extern "C" int fast_check(unsigned long long n_pairs, unsigned long long* counts, void* stream) {
    check<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(n_pairs, counts);
    return static_cast<int>(cudaGetLastError());
}
"""
FAST_PAIRS = 1 << 32


@pytest.mark.gpu
def test_fast_division_and_square_root_are_ieee(tmp_path):
    """``battery::div_fast`` and ``sqrt_fast``, which K1's and K3's district
    passes run in place of ``/`` and ``sqrtf``, give IEEE's bits wherever
    they claim their fast range: every float for the square root, 2^32
    random operand pairs for the division (``FAST_CHECK``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check is a CUDA kernel")
    src = tmp_path / "fast_check.cu"
    src.write_text(FAST_CHECK)
    lib = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).fast_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    assert fn(FAST_PAIRS, counts.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    fast_sqrt, bad_sqrt, fast_div, bad_div = (int(c) for c in counts.cpu())
    assert bad_sqrt == 0 and bad_div == 0, (bad_sqrt, bad_div)
    assert fast_sqrt > 1 << 30 and fast_div > 1 << 30, (fast_sqrt, fast_div)
