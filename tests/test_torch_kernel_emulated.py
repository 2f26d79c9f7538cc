"""The kernel sources of K1 (``csrc/battery_episode.cu``), K3
(``csrc/thermal_episode.cu``), K4 (``csrc/ev_episode.cu``) and K6
(``csrc/neighborhood_episode.cu``) themselves, compiled with ``g++`` and run
on the CPU by the thread-per-lane emulation of ``tests/_cuda_emulation.py``,
through their wrappers' CUDA branch, against their plain PyTorch versions:
every output and recorded row bit-equal. The shapes take the kernels'
edges: district counts that fill no block, several staged chunks with a
ragged last one, the quebec district's null battery, 40 and 128 buildings
(the shuffle tree's two and four values a lane), unequal knot counts, both
rewards; K1's and K3's plans differ in sign from building to building and
from step to step, so that every block takes both branches of the battery
event and of both end uses, at 5 knots (the build with the knot count
fixed) and 8 (the run-time build), hourly and at four steps an hour, and
from SOCs of 1e-35, outside the range of their branch-free division, so
that a step is redone with IEEE operations. The host build of that
division refines a correctly rounded reciprocal where the card refines its
MUFU estimate; the card's sequence is held against ``/`` and ``sqrtf`` by
``test_torch_kernel_battery.py::test_fast_division_and_square_root_are_ieee``.
The card's run of the same sources is the ``gpu`` tests of
``test_torch_kernel_battery.py``, ``test_torch_kernel_thermal.py``,
``test_torch_kernel_ev.py`` and ``test_torch_kernel_neighborhood.py``.

Tolerance: none. The emulation rounds every float operation as the card
does, and the plain versions' square root is made correctly rounded here,
as it is on the card (``_cuda_emulation.ieee_sqrt``)."""

import warnings

import numpy as np
import pytest
import torch

import _cuda_emulation as emulation
import test_torch_kernel_battery as battery_case
import test_torch_kernel_ev as ev_case
import test_torch_kernel_thermal as thermal_case
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.ops import ev as k4
from citylearn_tpu_torch.ops import neighborhood as k6
from citylearn_tpu_torch.ops import thermal as k3
from citylearn_tpu_torch.synthetic import write_neighborhood_dataset

HRS = np.arange(1, 25)
PLANS = {"cooling_or_heating_device": np.where(HRS < 12, 0.6, -0.5).astype(np.float32),
         "heating_device": np.where(HRS < 8, 0.9, 0.4).astype(np.float32),
         "electrical_storage": np.where(HRS < 9, 0.091, -0.08).astype(np.float32)}


@pytest.fixture(scope="module")
def k6_emulated(tmp_path_factory):
    lib = emulation.build("neighborhood_episode", tmp_path_factory.mktemp("k6"))
    return emulation.wrapper(k6, "neighborhood_episode", lib)


@pytest.fixture(scope="module")
def k1_emulated(tmp_path_factory):
    lib = emulation.build("battery_episode", tmp_path_factory.mktemp("k1"))
    return emulation.wrapper(k1, "battery_episode", lib)


@pytest.fixture(scope="module")
def k3_emulated(tmp_path_factory):
    lib = emulation.build("thermal_episode", tmp_path_factory.mktemp("k3"))
    return emulation.wrapper(k3, "thermal_episode", lib)


@pytest.fixture(scope="module")
def k4_emulated(tmp_path_factory):
    lib = emulation.build("ev_episode", tmp_path_factory.mktemp("k4"))
    return emulation.wrapper(k4, "ev_episode", lib)


def with_knots(curves, n):
    """Knot-major curves cut to ``n`` knots or padded with their last."""
    return [(c[:n] if n <= len(c) else torch.cat([c, c[-1:].expand(n - len(c), -1)]))
            .contiguous() for c in curves]


@pytest.mark.parametrize("quebec,n_knots", [(False, 5), (True, 5), (False, 8)],
                         ids=["eulp", "quebec", "eulp-8-knots"])
def test_k6_source_matches_plain_version(k6_emulated, tmp_path, monkeypatch, quebec, n_knots):
    """5 knots take the build with the knot count fixed, 8 the one that
    bounds the lookups at run time."""
    emulation.ieee_sqrt(monkeypatch)
    D, S = 131, 300                      # a block and 3 of 128; 3 chunks, the last ragged
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = write_neighborhood_dataset(str(tmp_path), 5, 3400, seed=5, quebec=quebec)
        cfg, params = pack(compile_schema(path, simulation_start_time_step=2952,
                                          episode_time_steps=S + 1), device="cpu")[:2]
    inputs = rollout_fast.neighborhood_episode_inputs(cfg, params, D, PLANS)
    rng = np.random.RandomState(0)
    rand = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (D, cfg.n_buildings))
                                       .astype(np.float32))
    inputs.update(dsoc0=rand(0.0, 1.0), soc0=rand(0.0, 1.0), eff0=rand(0.85, 0.95),
                  deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous(),
                  curves=with_knots(inputs["curves"], n_knots))
    ref = k6.neighborhood_episode_reference(**inputs, record=True)
    ours = k6_emulated(**inputs, record=True)
    assert k6_emulated.launches >= 1
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
    for a, b in zip(k6_emulated(**inputs), ref[:7]):
        assert torch.equal(a, b)
    if not quebec:
        assert (ref[7][k6.R_BBAL] > 0).any() and (ref[7][k6.R_BBAL] < 0).any()


@pytest.mark.parametrize("shape,n_districts,n_steps", [
    ((17, 8, 15, 1), 37, 70),            # the smoke shape: 3 blocks, the last 5 districts
    ((40, 35, 50, 3), 5, 40),            # 64 tree slots, 2 a lane
    ((128, 20, 30, 2), 3, 30),           # 128 tree slots, 4 a lane; one step a chunk
], ids=["smoke", "wide", "edge"])
@pytest.mark.parametrize("use_ev_reward", [True, False], ids=["ev_reward", "default_reward"])
def test_k4_source_matches_plain_version(k4_emulated, monkeypatch, shape, n_districts, n_steps,
                                         use_ev_reward):
    emulation.ieee_sqrt(monkeypatch)
    inputs = ev_case.as_torch(ev_case.random_inputs(n_districts, n_steps, shape, seed=1), "cpu")
    kw = dict(hours_ratio=1.0, ratio=1.0, ev_weights=ev_case.WEIGHTS,
              use_ev_reward=use_ev_reward, penalty_coefficient=2.0, record=True)
    ref = k4.ev_episode_reference(**inputs, **kw)
    ours = k4_emulated(**inputs, **kw)
    for name, a, b in zip(ev_case.OUTPUTS, ours, ref):
        assert torch.equal(a, b), name
    assert (ref[10][k4.R_CHC] != 0).any()


@pytest.mark.parametrize("knots", ["3-5", "5-3", "8-5"])
def test_k4_source_with_unequal_knot_counts(k4_emulated, monkeypatch, knots):
    """Buildings and EVs with 3 and 5 knots, 5 and 3, or 8 (the last knot
    repeated) and 5: the kernel bounds its lookups by the larger count, at
    compile time for 5 and at run time for 8, and predicates each lane by
    its own."""
    emulation.ieee_sqrt(monkeypatch)
    inputs = ev_case.as_torch(ev_case.random_inputs(11, 50, (17, 8, 15, 1), seed=3), "cpu")
    n_bld, n_ev = (int(n) for n in knots.split("-"))
    inputs["curves"] = with_knots(inputs["curves"], n_bld)
    inputs["ev_curves"] = with_knots(inputs["ev_curves"], n_ev)
    kw = dict(hours_ratio=1.0, ratio=1.0, ev_weights=ev_case.WEIGHTS, use_ev_reward=True,
              penalty_coefficient=2.0, record=True)
    for name, a, b in zip(ev_case.OUTPUTS, k4_emulated(**inputs, **kw),
                          k4.ev_episode_reference(**inputs, **kw)):
        assert torch.equal(a, b), name


# D = 131 fills no block of 32, 64 or 128 districts; S = 300 is three
# 128-step chunks, the last ragged
K13_DISTRICTS, K13_STEPS = 131, 300
# "tiny-soc" starts every seventh district at a SOC of 1e-35, below the
# range of the kernels' branch-free division, so that those steps take the
# redo with IEEE operations
K13_CASES = pytest.mark.parametrize("n_knots,hours_ratio,ratio,tiny", [
    (5, 1.0, 1.0, False), (8, 1.0, 1.0, False), (5, 0.25, 4.0, False), (5, 1.0, 1.0, True)],
    ids=["5-knots", "8-knots", "subhour", "tiny-soc"])


def tiny_socs(*socs):
    for soc in socs:
        soc[::7] = 1e-35


@K13_CASES
def test_k1_source_matches_plain_version(k1_emulated, monkeypatch, n_knots, hours_ratio, ratio,
                                         tiny):
    emulation.ieee_sqrt(monkeypatch)
    actions, series, bparams, curves, state = battery_case.as_torch(
        battery_case.random_inputs(K13_DISTRICTS, K13_STEPS, seed=4), "cpu")
    if tiny:
        tiny_socs(state[0])
    curves = with_knots(curves, n_knots)
    kw = dict(hours_ratio=hours_ratio, ratio=ratio)
    ref = k1.battery_episode_reference(actions, series, bparams, curves, *state, **kw,
                                       record=True)
    before = k1_emulated.launches
    ours = k1_emulated(actions, series, bparams, curves, *state, **kw, record=True)
    assert k1_emulated.launches == before + 1
    for name, a, b in zip(battery_case.OUTPUTS, ours, ref):
        assert torch.equal(a, b), name
    for a, b in zip(k1_emulated(actions, series, bparams, curves, *state, **kw), ref[:6]):
        assert torch.equal(a, b)
    # both branches of the event in every building, and distinct districts
    assert ((actions >= 0).any(0) & (actions < 0).any(0)).all()
    balance = ref[6][1]
    assert (balance > 0).any() and (balance < 0).any()
    assert not torch.equal(ref[3][0], ref[3][-1])


@K13_CASES
def test_k3_source_matches_plain_version(k3_emulated, monkeypatch, n_knots, hours_ratio, ratio,
                                         tiny):
    emulation.ieee_sqrt(monkeypatch)
    actions, series, bparams, curves, tparams, *state = thermal_case.as_torch(
        thermal_case.random_inputs(K13_DISTRICTS, K13_STEPS, seed=4), "cpu")
    if tiny:
        tiny_socs(*state[:3])
    curves = with_knots(curves, n_knots)
    kw = dict(hours_ratio=hours_ratio, ratio=ratio)
    ref = k3.thermal_episode_reference(actions, series, bparams, curves, tparams, *state, **kw,
                                       record=True)
    before = k3_emulated.launches
    ours = k3_emulated(actions, series, bparams, curves, tparams, *state, **kw, record=True)
    assert k3_emulated.launches == before + 1
    for name, a, b in zip(thermal_case.OUTPUTS, ours, ref):
        assert torch.equal(a, b), name
    for a, b in zip(k3_emulated(actions, series, bparams, curves, tparams, *state, **kw),
                    ref[:8]):
        assert torch.equal(a, b)
    # both orders of both end uses and both battery branches in every
    # building, and distinct districts
    for plan in actions:
        assert ((plan >= 0).any(0) & (plan < 0).any(0)).all()
    for row in (k3.R_CBAL, k3.R_DBAL, k3.R_BBAL):
        assert (ref[8][row] > 0).any() and (ref[8][row] < 0).any(), row
    assert not torch.equal(ref[5][0], ref[5][-1])
