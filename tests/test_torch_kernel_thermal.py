"""Kernel K3, the whole-episode thermal-storage rollout, and the fast path
around it: the port's plain version against the JAX package's Pallas
kernel run in interpret mode; ``run_thermal_episode`` and
``evaluate_scripted`` against the JAX package's; the kernel-backed KPI
table against the stepped one; the dispatch of ``evaluate_districts`` to
the kernel path; the kernel's split into a prelude and a district pass,
in plain PyTorch, against the plain version (bit-equal); the operation
count; and, on a CUDA card, the hand-written kernel against its plain
version.

Tolerances. Against JAX: 1e-5 relative to each output's scale. XLA:CPU
contracts ``a + b * c`` into fused multiply-adds (``energy_init + e *
rt`` in the tank and battery events, ``cost + net * price``) where the
port rounds twice; the last-bit differences then accumulate through the
SOC recurrences and the episode sums. KPI tables, ratios of such sums:
1e-5 relative with an absolute floor of 1e-6. On the card: the kernel is
built with ``-fmad=false`` and IEEE division and square root, so it
rounds every operation as the plain PyTorch version does; it is held to
1e-6 relative on the per-step record and the state and 1e-5 on the
episode sums at 512 districts and 5 knots, and bit-equal at 301 districts
and 8 knots.

The card's machine has no JAX: the JAX side is imported inside the tests
that compare with it, and the ``gpu`` test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_thermal.py``."""

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import evaluate_fast, rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.ops import battery as k1
from citylearn_tpu_torch.ops import thermal as k3
from citylearn_tpu_torch.synthetic import write_thermal_dataset

S, B = 168, 9
HOURS = np.arange(1, 25)
PLANS = {"cooling_storage": np.where(HOURS < 9, 0.2, -0.15).astype(np.float32),
         "dhw_storage": np.where(HOURS < 6, 0.1, -0.1).astype(np.float32),
         "electrical_storage": np.where(HOURS < 9, 0.091, -0.08).astype(np.float32)}
OUTPUTS = ("reward", "cost", "emission", "cooling_soc", "dhw_soc", "soc", "eff", "deg",
           "record")
SUMS = ("reward", "cost", "emission")


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def random_inputs(D, n_steps, seed=0):
    """Seeded K3 inputs in the port's layout: 3 plans and 7 series (S, B),
    bparams (8, B), knot-major curves (5, B), tparams (20, B), five
    per-district states (D, B). The district is heterogeneous: heat pumps
    and heaters, a zero-capacity DHW tank, finite and infinite power caps,
    an undersized cooling device, and a step where the outdoor
    temperature equals the cooling target."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    actions = [f(-1.0, 1.0, (n_steps, B)) for _ in range(3)]
    actions[0][5] = 0.0
    outdoor = f(-5.0, 40.0, (n_steps, B))
    outdoor[3] = 8.5
    series = [f(0.2, 3.0, (n_steps, B)), f(0.0, 3.0, (n_steps, B)),
              f(0.1, 0.6, (n_steps, B)), f(0.05, 0.5, (n_steps, B)),
              f(0.0, 6.0, (n_steps, B)), f(0.0, 2.0, (n_steps, B)), outdoor]
    cap = f(2.0, 10.0, B)
    bparams = np.stack([cap, f(1.0, 5.0, B), f(0.0, 0.01, B), f(0.0, 1.0, B),
                        f(0.7, 1.0, B), f(1e-5, 1e-4, B), np.zeros(B, np.float32),
                        np.zeros(B, np.float32)])
    pec_x = np.tile(np.array([0, 0.3, 0.7, 0.8, 1], np.float32)[:, None], (1, B))
    pec_y = f(0.8, 0.95, (5, B))
    cpc_x = np.tile(np.array([0, 0.8, 1, 1, 1], np.float32)[:, None], (1, B))
    cpc_y = np.tile(np.array([1, 1, 0.2, 0.2, 0.2], np.float32)[:, None], (1, B))
    hp = (np.arange(B) % 3 == 2).astype(np.float32)
    inf = np.full(B, np.inf, np.float32)
    capped = lambda lo, hi: np.where(np.arange(B) == 3, f(lo, hi, B), inf).astype(np.float32)
    ccap, dcap = f(4.0, 12.0, B), f(1.0, 4.0, B)
    dcap[2] = 0.0
    cool_nominal = f(2.0, 5.0, B)
    cool_nominal[4] = 0.3
    tparams = np.stack([
        cool_nominal, f(0.2, 0.3, B), np.full(B, 8.5, np.float32), np.ones(B, np.float32),
        f(2.0, 4.0, B), np.where(hp > 0, f(0.2, 0.3, B), f(0.9, 0.99, B)).astype(np.float32),
        f(45.0, 50.0, B), hp,
        ccap, np.sqrt(f(0.9, 0.98, B)), f(0.001, 0.009, B), capped(0.8, 1.5), capped(0.8, 1.5),
        ccap,
        dcap, np.sqrt(f(0.9, 0.98, B)), f(0.001, 0.009, B), capped(0.3, 0.8), capped(0.3, 0.8),
        f(1.0, 4.0, B)])
    assert tparams.shape == (k3.N_TROWS, B)
    state = [f(0.0, 1.0, (D, B)), f(0.0, 1.0, (D, B)), f(0.0, 1.0, (D, B)),
             f(0.85, 0.95, (D, B)), np.broadcast_to(cap, (D, B)) * f(0.9, 1.0, (D, B))]
    return actions, series, bparams, [pec_x, pec_y, cpc_x, cpc_y], tparams, state


def as_torch(inputs, device):
    actions, series, bparams, curves, tparams, state = inputs
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=device)
    return ([t(x) for x in actions], [t(x) for x in series], t(bparams),
            [t(x) for x in curves], t(tparams), *[t(x) for x in state])


def test_reference_matches_jax_interpret():
    import jax.numpy as jnp

    from citylearn_tpu.ops.pallas_thermal import thermal_episode as jax_thermal_episode

    D = 256
    actions, series, bparams, curves, tparams, state = inputs = random_inputs(D, S)
    ours = k3.thermal_episode(*as_torch(inputs, "cpu"), hours_ratio=1.0, ratio=1.0, record=True)
    # the JAX kernel's TPU layout: 128 lanes, 256-step chunks
    t_pad = 256
    lanes = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 128 - B)], constant_values=1.0)
    rows = lambda a: np.pad(a, [(0, t_pad - S), (0, 0)])
    ref = jax_thermal_episode(
        tuple(jnp.asarray(rows(lanes(x))) for x in actions),
        tuple(jnp.asarray(rows(lanes(x))) for x in series),
        jnp.asarray(lanes(bparams)), tuple(jnp.asarray(lanes(c)) for c in curves),
        jnp.asarray(lanes(tparams)), *[jnp.asarray(lanes(x)) for x in state],
        n_steps=S, hours_ratio=1.0, ratio=1.0, n_knots=5, record=True, interpret=True)
    for name, a, b in zip(OUTPUTS, ours, ref):
        b = np.asarray(b)[..., :B]
        assert_close(a, b[:, :S] if name == "record" else b, name)
    # both priority orders of both blocks, both battery branches, the
    # saturated device and distinct districts are all exercised
    rec = ours[8]
    assert rec.shape == (k3.N_TREC, S, B)
    for row in (k3.R_CBAL, k3.R_DBAL, k3.R_BBAL):
        assert (rec[row] > 0).any() and (rec[row] < 0).any(), row
    assert float(rec[k3.R_DBAL][:, 2].abs().max()) == 0.0       # the absent DHW tank
    assert (rec[k3.R_COUT][:, 4] < torch.tensor(series[4])[:, 4] - 1e-3).any()
    assert torch.isfinite(rec).all()
    assert not torch.equal(ours[1][0], ours[1][1])


@pytest.fixture(scope="module")
def district(tmp_path_factory):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack

    path = write_thermal_dataset(str(tmp_path_factory.mktemp("ds")), B, 5000, seed=5)
    kw = dict(episode_time_steps=S + 1, simulation_start_time_step=4700,
              simulation_end_time_step=4899)
    return (pack(compile_schema(path, **kw), device="cpu")[:2],
            jax_pack(jax_compile(path, **kw))[:2])


@pytest.mark.parametrize("offset", [0, 16])
def test_run_thermal_episode_matches_jax(district, offset):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = district
    assert rollout_fast.eligible_thermal(cfg) and not rollout_fast.eligible(cfg)
    n = S - offset
    ours = rollout_fast.run_thermal_episode(cfg, params, 3, PLANS, n_steps=n,
                                            record_series=True, data_offset=offset,
                                            device="cpu")
    ref = jax_rollout_fast.run_thermal_episode(jcfg, jparams, 256, PLANS, n_steps=n,
                                               interpret=True, record_series=True,
                                               data_offset=offset)
    assert ours[0].shape == (3, B) and ours[8].shape == (k3.N_TREC, n, B)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, np.asarray(b)[:3] if name != "record" else b, name)
    assert (ours[8][k3.R_CBAL] > 0).any() and (ours[8][k3.R_CBAL] < 0).any()


@pytest.mark.parametrize("baseline", ["_without_storage", "_without_storage_and_pv"])
def test_evaluate_scripted_matches_jax(district, baseline):
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate_scripted

    (cfg, params), (jcfg, jparams) = district
    assert evaluate_fast.kernel_family(cfg) == "thermal"
    plans = dict(PLANS)
    plans["cooling_storage"] = np.tile(PLANS["cooling_storage"][:, None], (1, B))
    plans["cooling_storage"][:, 2] *= -1.0
    ours, rec = evaluate_scripted(cfg, params, ScriptedPolicy(plans),
                                  baseline_condition=baseline, return_series=True,
                                  device="cpu")
    ref, jrec = jax_evaluate_scripted(jcfg, jparams, JaxScriptedPolicy(plans),
                                      baseline_condition=baseline, interpret=True,
                                      return_series=True)
    assert_close(rec, jrec, "record")
    assert set(ours) == set(ref)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("central", [False, True], ids=["decentral", "central"])
def test_kernel_table_matches_stepped(tmp_path, central):
    """The KPI table assembled from K3's recorded rows equals the one the
    stepped ``district_step`` path collects, 1e-5 relative (floor 1e-6)."""
    path = write_thermal_dataset(str(tmp_path), B, 5000, seed=6)
    cfg, params, _ = pack(compile_schema(
        path, central_agent=central, episode_time_steps=S + 1,
        simulation_start_time_step=4700, simulation_end_time_step=4899), device="cpu")
    policy = ScriptedPolicy(PLANS)
    fast = evaluate_scripted(cfg, params, policy, device="cpu")
    states = batched_initial_states(cfg, params, 2, device="cpu")
    stepped = evaluate_districts(cfg, params, states, policy.as_policy_fn(cfg, params, S),
                                 device="cpu")
    assert set(fast) == set(stepped) and len(fast) == 37
    for k in fast:
        np.testing.assert_allclose(fast[k].numpy(), stepped[k][0].numpy(), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    # storage moved the table off the no-storage baseline
    assert abs(float(fast["district|cost_total"]) - 1.0) > 1e-3


def test_evaluate_districts_dispatches_fresh_states(district, monkeypatch):
    (cfg, params), _ = district
    calls = []
    real = evaluate_fast.evaluate_scripted
    monkeypatch.setattr(evaluate_fast, "evaluate_scripted",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    policy = ScriptedPolicy(PLANS)
    states = batched_initial_states(cfg, params, 3, device="cpu")
    before = k3.thermal_episode.launches
    fast = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    assert k3.thermal_episode.launches == before     # CPU tensors: no kernel launch
    assert fast["building|cost_total"].shape == (3, B)
    # a hand-modified tank state is not fresh: the stepped path serves it
    states.cooling_storage_soc[1] = 0.9
    stepped = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    for k in fast:
        np.testing.assert_allclose(stepped[k][0].numpy(), fast[k][0].numpy(), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    assert not np.allclose(stepped["building|cost_total"][1].numpy(),
                           fast["building|cost_total"][1].numpy())


def test_prelude_and_district_pass_rebuild_the_reference(tmp_path):
    """The kernel's split, in plain PyTorch: the prelude's rows once per
    (step, building) and the district pass from them rebuild
    ``thermal_episode_reference``'s outputs and record bit for bit, on the
    synthetic district's summer window with per-district seeded states,
    hourly and at four steps an hour."""
    path = write_thermal_dataset(str(tmp_path), B, 5000, seed=7)
    cfg, params, _ = pack(compile_schema(path, episode_time_steps=S + 1,
                                         simulation_start_time_step=4700,
                                         simulation_end_time_step=4899), device="cpu")
    rng = np.random.RandomState(3)
    # (S, B) tank plans whose signs differ across buildings and steps
    plans = dict(PLANS, cooling_storage=rng.uniform(-0.3, 0.3, (S, B)).astype(np.float32),
                 dhw_storage=rng.uniform(-0.3, 0.3, (S, B)).astype(np.float32))
    inputs = rollout_fast.thermal_episode_inputs(cfg, params, 5, plans)
    inputs["tparams"][k3.DT_CONV] = inputs["tparams"][k3.DT_CAP]   # both DHW orders
    rand = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (5, B)).astype(np.float32))
    inputs.update(csoc0=rand(0.0, 1.0), dsoc0=rand(0.0, 1.0), soc0=rand(0.0, 1.0),
                  eff0=rand(0.85, 0.95), deg0=(inputs["bparams"][0] * rand(0.9, 1.0)))
    for hours_ratio, ratio in ((1.0, 1.0), (0.25, 4.0)):
        inputs.update(hours_ratio=hours_ratio, ratio=ratio)
        ref = k3.thermal_episode_reference(**inputs, record=True)
        pre = k3.thermal_prelude_reference(inputs["actions"], inputs["series"],
                                           inputs["bparams"], inputs["tparams"], hours_ratio,
                                           ratio)
        ours = k3.thermal_district_reference(
            pre, inputs["tparams"], inputs["bparams"], inputs["curves"],
            *(inputs[k] for k in ("csoc0", "dsoc0", "soc0", "eff0", "deg0")), ratio,
            record=True)
        for name, a, b in zip(OUTPUTS, ours, ref):
            assert torch.equal(a, b), name
        for row in (k3.R_CBAL, k3.R_DBAL, k3.R_BBAL):
            assert (ref[8][row] > 0).any() and (ref[8][row] < 0).any(), row
        assert not torch.equal(ref[1][0], ref[1][1])


def test_operation_count_follows_the_plans():
    """The prelude's work counts once per building-step, the rest once
    per district and building-step."""
    actions = [torch.tensor(a) for a in random_inputs(1, 24)[0]]
    steps = 24 * B
    discharging = int((actions[0] < 0).sum() + (actions[1] < 0).sum())
    per_district = (k1.operation_count(actions[2], 5, 1) - 2 * steps
                    + steps * (14 + 2 * 12) + 9 * discharging)
    prelude = steps * (14 + 4 + 3 + 2 * 18) - 7 * discharging + 2 * steps
    assert k3.operation_count(actions, 5, 7) - k3.operation_count(actions, 5, 1) \
        == 6 * per_district
    assert k3.operation_count(actions, 5, 1) == per_district + prelude
    discharging = [torch.full_like(a, -1.0) for a in actions[:2]] + [actions[2]]
    idle = [torch.zeros_like(a) for a in actions[:2]] + [actions[2]]
    assert k3.operation_count(discharging, 5, 1) - k3.operation_count(idle, 5, 1) \
        == 2 * 2 * 24 * B


def test_wrapper_rejects_other_devices():
    inputs = as_torch(random_inputs(2, 8), "meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k3.thermal_episode(*inputs, hours_ratio=1.0, ratio=1.0)


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
    actions, series, bparams, curves, tparams, *state = as_torch(
        random_inputs(D, n_steps, seed=1), "cuda")
    curves = [torch.cat([c, c[-1:].expand(n_knots - 5, -1)]).contiguous() for c in curves]
    inputs = (actions, series, bparams, curves, tparams, *state)
    before = k3.thermal_episode.launches
    ours = k3.thermal_episode(*inputs, hours_ratio=1.0, ratio=1.0, record=True)
    torch.cuda.synchronize()
    assert k3.thermal_episode.launches == before + 1
    ref = k3.thermal_episode_reference(*inputs, hours_ratio=1.0, ratio=1.0, record=True)
    for name, a, b in zip(OUTPUTS, ours, ref):
        if n_knots == 5:
            assert_close(a, b.cpu(), name, rtol=1e-5 if name in SUMS else 1e-6)
        else:
            assert torch.equal(a, b), name
