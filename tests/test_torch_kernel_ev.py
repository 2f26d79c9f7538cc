"""Kernel K4, the whole-episode EV-district rollout, and the fast path
around it: the port's plain version against the JAX package's Pallas
kernel run in interpret mode (the lane and chunk padding of its TPU
layout done here); ``apply_charging_constraints_np``,
``run_ev_episode`` and ``evaluate_scripted`` against the JAX package's;
the kernel-backed KPI table against the stepped one; the dispatch of
``evaluate_districts`` to the kernel path; the plain version of the
kernel's prelude (what every district shares) read in place of the plain
version's own per-step charger requests and window tests, bit for bit;
and, on a CUDA card, the hand-written kernel against its plain version.

Tolerances. Against JAX: 1e-5 relative to each output's scale. XLA:CPU
contracts ``a + b * c`` into fused multiply-adds (``energy_init + e *
rt`` in the battery events, ``cost + net * price``) where the port rounds
twice, and the Pallas kernel sums chargers into buildings with a matrix
product; the last-bit differences then accumulate through the SOC
recurrences and the episode sums. KPI tables, ratios of such sums: 1e-5
relative with an absolute floor of 1e-6. The charging-constraint scaling
is the same numpy arithmetic on both sides: exact. On the card: the
kernel is built with ``-fmad=false`` and IEEE division and square root
and sums in the plain version's order, so it rounds every operation as
the plain PyTorch version does; it is held to 1e-6 relative on the
per-step record and the state and 1e-5 on the episode sums before it is
held bit-equal.

The card's machine has no JAX: the JAX side is imported inside the tests
that compare with it, and the ``gpu`` test runs there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_ev.py``."""

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import evaluate_fast, rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.ops import ev as k4
from citylearn_tpu_torch.synthetic import write_ev_dataset

S = 168
B, C, V, W = 6, 4, 7, 1
HOURS = np.arange(1, 25)
PLANS = {
    "electrical_storage": np.where(HOURS < 9, 0.091, -0.08).astype(np.float32),
    "electric_vehicle_storage": np.select(
        [HOURS < 7, HOURS < 10, HOURS < 15, HOURS < 20], [0.4, 1.0, -1.0, -0.6],
        0.8).astype(np.float32),
    "washing_machine": np.ones(24, np.float32),
}
OUTPUTS = ("reward", "cost", "emission", "soc", "eff", "deg", "ev_soc", "ev_eff", "ev_deg",
           "wm_initiated", "record")
SUMS = ("reward", "cost", "emission")
WEIGHTS = (-5.0, -2.0, -10.0, -5.0, 10.0, 5.0, 5.0)


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def _battery_table(f, n):
    """(8, n) battery rows and four (5, n) knot-major curves."""
    cap = f(40.0, 80.0, n)
    table = np.stack([cap, f(7.0, 30.0, n), f(0.0, 0.01, n), f(0.2, 0.8, n), f(0.7, 1.0, n),
                      f(1e-5, 1e-4, n), np.zeros(n, np.float32), np.zeros(n, np.float32)])
    col = lambda knots: np.tile(np.array(knots, np.float32)[:, None], (1, n))
    curves = [col([0, 0.3, 0.7, 0.8, 1]), f(0.8, 0.95, (5, n)),
              col([0, 0.8, 1, 1, 1]), col([1, 1, 0.2, 0.2, 0.2])]
    return table, curves


def random_inputs(D, n_steps, shape=(B, C, V, W), seed=0):
    """Seeded K4 inputs in the port's layout as a dict of numpy arrays (the
    keyword arguments of ``ops.ev.ev_episode`` but the scalars). Two
    chargers stand on building 0 and none on building 1; charger 0 has a
    power-dependent efficiency curve; per step every charger hosts another
    EV or none, never one EV twice; force and drift events are sparse; the
    machine's window opens daily; states differ from district to district."""
    nb, nc, nv, nw = shape
    rng = np.random.RandomState(seed)
    f = lambda lo, hi, size: rng.uniform(lo, hi, size).astype(np.float32)
    a_ev = f(-1.0, 1.0, (n_steps, nc))
    a_ev[rng.rand(n_steps, nc) < 0.3] = 0.0
    actions = [f(-1.0, 1.0, (n_steps, nb)), a_ev,
               (rng.rand(n_steps, nw) < 0.4).astype(np.float32)]
    conn = np.stack([rng.permutation(nv)[:nc] for _ in range(n_steps)]).astype(np.int32)
    conn[rng.rand(n_steps, nc) < 0.4] = -1
    sparse = lambda vals, p: np.where(rng.rand(*vals.shape) < p, vals, np.nan).astype(np.float32)
    t = np.arange(n_steps)
    start = ((t // 24) * 24 + 10).astype(np.float32)
    open_ = (t % 24 >= 6) & (t % 24 <= 20)
    window = lambda a: np.tile(np.where(open_, a, -1.0).astype(np.float32)[:, None], (1, nw))
    series = [f(0.2, 3.0, (n_steps, nb)), f(0.0, 3.0, (n_steps, nb)),
              f(0.1, 0.6, (n_steps, nb)), f(0.05, 0.5, (n_steps, nb)),
              conn, f(0.5, 1.0, (n_steps, nc)),
              rng.randint(0, 5, (n_steps, nc)).astype(np.float32),
              sparse(f(0.2, 0.9, (n_steps, nv)), 0.05),
              sparse(np.clip(rng.normal(1.0, 0.2, (n_steps, nv)), 0.6, 1.4), 0.3),
              window(start), window(start + 5.0), f(0.5, 3.0, (n_steps, nw))]
    bparams, curves = _battery_table(f, nb)
    evparams, ev_curves = _battery_table(f, nv)
    maxd = f(5.0, 9.0, nc)
    maxd[2::3] = 0.0
    cparams = np.stack([f(6.0, 11.0, nc), np.zeros(nc, np.float32), maxd,
                        np.zeros(nc, np.float32)])
    cparams[1, 1], cparams[3, 1] = 0.5, 0.4
    flat = lambda: np.stack([np.zeros(nc), np.ones(nc), np.ones(nc), np.ones(nc)]
                            ).astype(np.float32)
    ch_curves = [flat(), np.tile(f(0.9, 0.98, nc), (4, 1)), flat(),
                 np.tile(f(0.9, 0.98, nc), (4, 1))]
    for x, y, knots in ((0, 1, ([0, 0.3, 0.7, 1], [0.83, 0.9, 0.95, 0.9])),
                        (2, 3, ([0, 0.5, 1, 1], [0.8, 0.93, 0.88, 0.88]))):
        ch_curves[x][:, 0], ch_curves[y][:, 0] = knots
    ch_bld = np.array([0, 0] + [2 + (c % (nb - 2)) for c in range(nc - 2)], np.int32)
    wm_bld = np.array([1 + 2 * w for w in range(nw)], np.int32) % nb
    scaled = lambda table, n: np.broadcast_to(table[0], (D, n)) * f(0.9, 1.0, (D, n))
    state0 = [f(0.0, 1.0, (D, nb)), f(0.85, 0.95, (D, nb)), scaled(bparams, nb),
              f(0.0, 1.0, (D, nv)), f(0.85, 0.95, (D, nv)), scaled(evparams, nv),
              np.zeros((D, nw), np.float32)]
    viol = np.where(rng.rand(n_steps, nb) < 0.3, f(-0.5, 1.5, (n_steps, nb)), 0.0)
    return dict(actions=actions, series=series, bparams=bparams, curves=curves,
                cparams=cparams, ch_curves=ch_curves, evparams=evparams,
                ev_curves=ev_curves, ch_bld=ch_bld, wm_bld=wm_bld, state0=state0,
                viol=viol.astype(np.float32))


def as_torch(inputs, device):
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=device)
    return {k: [t(x) for x in v] if isinstance(v, list) else t(v) for k, v in inputs.items()}


def _jax_episode(inputs, n_steps, use_ev_reward, penalty):
    """The JAX Pallas kernel in interpret mode on the same inputs, in its
    TPU layout: 128 lanes, 128-step chunks, float connection stream,
    one-hot building matrices, identity curves on the lanes past the end."""
    import jax.numpy as jnp

    from citylearn_tpu.ops.pallas_ev import ev_episode as jax_ev_episode

    t_pad = -(-n_steps // 128) * 128

    def lanes(a, fill=0.0):
        a = np.asarray(a, np.float32)
        out = np.full(a.shape[:-1] + (128,), fill, np.float32)
        out[..., :a.shape[-1]] = a
        return out

    def rows(a, fill=0.0):
        out = np.full((t_pad, 128), fill, np.float32)
        out[:n_steps] = lanes(a, fill)
        return jnp.asarray(out)

    def curve_set(curves):
        out = []
        for i, c in enumerate(curves):
            ident = np.ones(c.shape[0], np.float32)
            if i % 2 == 0:
                ident[0] = 0.0
            padded = np.tile(ident[:, None], (1, 128))
            padded[:, :c.shape[1]] = c
            out.append(jnp.asarray(padded))
        return tuple(out)

    def onehot(index):
        out = np.zeros((128, 128), np.float32)
        out[np.arange(len(index)), index] = 1.0
        return jnp.asarray(out)

    s = inputs["series"]
    fills = [0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, np.nan, np.nan, -1.0, -1.0, 0.0]
    return jax_ev_episode(
        tuple(rows(a) for a in inputs["actions"]),
        tuple(rows(x, fill) for x, fill in zip(s, fills)),
        jnp.asarray(lanes(inputs["bparams"])), curve_set(inputs["curves"]),
        jnp.asarray(lanes(inputs["cparams"])), curve_set(inputs["ch_curves"]),
        jnp.asarray(lanes(inputs["evparams"])), curve_set(inputs["ev_curves"]),
        onehot(inputs["ch_bld"]), onehot(inputs["wm_bld"]),
        tuple(jnp.asarray(lanes(x)) for x in inputs["state0"]),
        n_steps=n_steps, hours_ratio=1.0, ratio=1.0, n_knots=5, ev_knots=5, ch_knots=4,
        ev_weights=WEIGHTS, use_ev_reward=use_ev_reward, viol=rows(inputs["viol"]),
        penalty_coefficient=penalty, record=True, interpret=True)


@pytest.mark.parametrize("use_ev_reward", [True, False], ids=["ev_reward", "default_reward"])
def test_reference_matches_jax_interpret(use_ev_reward):
    D = 256
    inputs = random_inputs(D, S)
    ours = k4.ev_episode(**as_torch(inputs, "cpu"), hours_ratio=1.0, ratio=1.0,
                         ev_weights=WEIGHTS, use_ev_reward=use_ev_reward,
                         penalty_coefficient=2.0, record=True)
    ref = _jax_episode(inputs, S, use_ev_reward, 2.0)
    widths = (B, B, B, B, B, B, V, V, V, W, B)
    assert len(ours) == len(ref) == 11
    for name, a, b, n in zip(OUTPUTS, ours, ref, widths):
        b = np.asarray(b)[..., :n]
        assert_close(a, b[:, :S] if name == "record" else b, name)
    # what the episode exercised: force and drift events, chargers
    # charging and discharging and one EV per charger at most, the machine
    # triggered, both battery branches, a violation penalty in the EV
    # reward, districts that differ
    rec = ours[10]
    assert rec.shape == (k4.N_EREC, S, B) and torch.isfinite(rec).all()
    conn = inputs["series"][4]
    assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in conn)
    assert np.isfinite(inputs["series"][7]).any() and np.isfinite(inputs["series"][8]).any()
    for row in (k4.R_BBAL, k4.R_CHC):
        assert (rec[row] > 0).any() and (rec[row] < 0).any(), row
    assert float(rec[k4.R_CHC][:, 1].abs().max()) == 0.0         # the building with no charger
    assert (rec[k4.R_WMC][:, 1] > 0).any()
    assert (rec[k4.R_REW] != 0).any()
    if use_ev_reward:
        assert (rec[k4.R_REW] > 0).any()                        # shaping terms, not -max(net, 0)
    assert not torch.equal(ours[1][0], ours[1][1])
    assert not torch.equal(ours[8][0], ours[8][1])
    assert (ours[6] > 0).any()


@pytest.mark.parametrize("use_ev_reward", [True, False], ids=["ev_reward", "default_reward"])
def test_prelude_rebuilds_the_plain_version(district, use_ev_reward):
    """The charger requests and machine window tests computed once for all
    steps, as the kernel's prelude does, and read by the per-district
    loop give the plain version's outputs and rows bit for bit."""
    (cfg, params), _ = district
    plans = ScriptedPolicy(PLANS).expanded(cfg, params, S)
    inputs = rollout_fast.ev_episode_inputs(cfg, params, 3, plans)
    inputs.update(use_ev_reward=use_ev_reward)
    prelude = k4.ev_prelude_reference(inputs["actions"], inputs["series"], inputs["cparams"],
                                      inputs["ch_curves"], inputs["hours_ratio"])
    assert [tuple(x.shape) for x in prelude] == [(S, C)] * 3 + [(S, W)] * 2
    assert bool(prelude[3].any()) and (prelude[0] != 0).any()
    full = k4.ev_episode_reference(**inputs, record=True)
    del inputs["ch_curves"]
    split = k4.ev_district_reference(prelude, **inputs, record=True)
    for name, a, b in zip(OUTPUTS, split, full):
        assert torch.equal(a, b), name
    assert (full[10][k4.R_CHC] != 0).any() and (full[10][k4.R_WMC] > 0).any()


def test_tree_sum_is_a_sum():
    x = torch.tensor(np.random.RandomState(0).uniform(-1, 1, (5, 17)).astype(np.float32))
    np.testing.assert_allclose(k4._tree_sum(x)[:, 0].numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert k4._tree_sum(x[:, :1]).shape == (5, 1)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "constraints"])
def district(request, tmp_path_factory):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack

    path = write_ev_dataset(str(tmp_path_factory.mktemp("ds")), B, C, V, W, 400, seed=4,
                            constraints=request.param)
    kw = dict(episode_time_steps=S + 1)
    return (pack(compile_schema(path, **kw), device="cpu")[:2],
            jax_pack(jax_compile(path, **kw))[:2])


def test_charging_constraints_equal_jax(district):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = district
    plan = np.random.RandomState(1).uniform(-1.0, 1.0, (S, C)).astype(np.float32)
    if not cfg.has_charging_constraints:
        pytest.skip("the district without constraints has no limits to apply")
    ours = rollout_fast.apply_charging_constraints_np(cfg, params, plan)
    ref = jax_rollout_fast.apply_charging_constraints_np(jcfg, jparams, plan)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (ours[1] > 0).any() and (ours[0] < plan).any()


@pytest.mark.parametrize("offset", [0, 16])
def test_run_ev_episode_matches_jax(district, offset):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = district
    assert rollout_fast.eligible_ev(cfg) and jax_rollout_fast.eligible_ev(jcfg)
    assert not rollout_fast.eligible(cfg) and not rollout_fast.eligible_thermal(cfg)
    n = S - offset
    ours = rollout_fast.run_ev_episode(cfg, params, 3, PLANS, n_steps=n, record_series=True,
                                       data_offset=offset, device="cpu")
    ref = jax_rollout_fast.run_ev_episode(jcfg, jparams, 256, PLANS, n_steps=n,
                                          interpret=True, record_series=True,
                                          data_offset=offset)
    assert ours[0].shape == (3, B) and ours[6].shape == (3, V) and ours[9].shape == (3, W)
    assert ours[10].shape == (k4.N_EREC, n, B)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, np.asarray(b)[:3] if name != "record" else b, name)
    rec = ours[10]
    assert (rec[k4.R_CHC] > 0).any() and (rec[k4.R_CHC] < 0).any()
    assert (rec[k4.R_WMC] > 0).any()


@pytest.mark.parametrize("baseline", ["_without_storage", "_without_storage_and_pv"])
def test_evaluate_scripted_matches_jax(district, baseline):
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate_scripted

    (cfg, params), (jcfg, jparams) = district
    assert evaluate_fast.kernel_family(cfg) == "ev"
    plans = dict(PLANS)
    plans["electric_vehicle_storage"] = np.tile(PLANS["electric_vehicle_storage"][:, None],
                                                (1, C))
    plans["electric_vehicle_storage"][:, 1] *= -0.5            # per-charger plans
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
def test_kernel_table_matches_stepped(district, central):
    """The KPI table assembled from K4's recorded rows equals the one the
    stepped ``district_step`` path collects, 1e-5 relative (floor 1e-6);
    on the decentral district the kernel's per-step reward also equals the
    stepped one (under a central agent the kernel's multiplier stays per
    building where the stepped reward takes the district's, as in the JAX
    package)."""
    import dataclasses

    (cfg, params), _ = district
    cfg = dataclasses.replace(cfg, central_agent=central)
    policy = ScriptedPolicy(PLANS)
    fast, rec = evaluate_scripted(cfg, params, policy, return_series=True, device="cpu")
    states = batched_initial_states(cfg, params, 2, device="cpu")
    stepped = evaluate_districts(cfg, params, states, policy.as_policy_fn(cfg, params, S),
                                 device="cpu")
    assert set(fast) == set(stepped) and len(fast) == 37
    for k in fast:
        np.testing.assert_allclose(fast[k].numpy(), stepped[k][0].numpy(), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    # storage and chargers moved the table off the no-storage baseline
    assert abs(float(fast["district|cost_total"]) - 1.0) > 1e-3
    if not central:
        from citylearn_tpu_torch.core.step import district_step

        fn = policy.as_policy_fn(cfg, params, S)
        st = batched_initial_states(cfg, params, 1, device="cpu")
        rewards = []
        for _ in range(S):
            st, out = district_step(cfg, params, st, fn(params, st))
            rewards.append(out.reward[0])
        assert_close(rec[k4.R_REW], torch.stack(rewards), "reward")


def test_evaluate_districts_dispatches_fresh_states(district, monkeypatch):
    (cfg, params), _ = district
    calls = []
    real = evaluate_fast.evaluate_scripted
    monkeypatch.setattr(evaluate_fast, "evaluate_scripted",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    policy = ScriptedPolicy(PLANS)
    states = batched_initial_states(cfg, params, 3, device="cpu")
    before = k4.ev_episode.launches
    fast = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    assert k4.ev_episode.launches == before          # CPU tensors: no kernel launch
    assert fast["building|cost_total"].shape == (3, B)
    # a hand-modified battery state is not fresh: the stepped path serves it
    states.battery_soc[1] = 0.9
    stepped = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1]
    for k in fast:
        np.testing.assert_allclose(stepped[k][0].numpy(), fast[k][0].numpy(), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    assert not np.allclose(stepped["building|cost_total"][1].numpy(),
                           fast["building|cost_total"][1].numpy())


def test_operation_count_follows_the_data():
    inputs = as_torch(random_inputs(1, 24), "cpu")
    conn = inputs["series"][4]
    count = lambda c, reward, d=1: k4.operation_count(inputs["actions"], c, 5, 5, 4, V, d, reward)
    # the prelude's charger requests and window tests appear once, each
    # district's share once per district
    shared = 24 * C * (12 + 4 + 6) + 24 * W * 7
    assert count(conn, True, 7) - count(conn, True) == 6 * (count(conn, True) - shared)
    assert count(conn, True, 7) == 7 * count(conn, True) - 6 * shared
    assert count(conn, True) > count(conn, False)
    # a charger with no EV runs no battery event
    assert count(conn, False) > count(torch.full_like(conn, -1), False)


def test_wrapper_rejects_other_devices_and_sizes(district):
    import dataclasses

    inputs = as_torch(random_inputs(2, 8), "meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k4.ev_episode(**inputs, hours_ratio=1.0, ratio=1.0, ev_weights=WEIGHTS,
                      use_ev_reward=True)
    (cfg, params), _ = district
    wide = dataclasses.replace(cfg, n_evs=k4.MAX_LANES + 1)
    with pytest.raises(ValueError, match="up to 128"):
        rollout_fast.run_ev_episode(wide, params, 1, PLANS, device="cpu")
    thermal = dataclasses.replace(cfg, any_cooling=True)
    with pytest.raises(ValueError, match="not eligible"):
        rollout_fast.run_ev_episode(thermal, params, 1, PLANS, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(17, 8, 15, 1), (40, 35, 50, 3), (128, 20, 30, 2)],
                         ids=["smoke", "wide", "edge"])
@pytest.mark.parametrize("use_ev_reward", [True, False], ids=["ev_reward", "default_reward"])
def test_cuda_kernel_matches_reference(shape, use_ev_reward):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    D, n_steps = 301, 400
    inputs = as_torch(random_inputs(D, n_steps, shape, seed=1), "cuda")
    kw = dict(hours_ratio=1.0, ratio=1.0, ev_weights=WEIGHTS, use_ev_reward=use_ev_reward,
              penalty_coefficient=2.0, record=True)
    before = k4.ev_episode.launches
    ours = k4.ev_episode(**inputs, **kw)
    torch.cuda.synchronize()
    assert k4.ev_episode.launches == before + 1
    ref = k4.ev_episode_reference(**inputs, **kw)
    for name, a, b in zip(OUTPUTS, ours, ref):
        assert_close(a, b.cpu(), name, rtol=1e-5 if name in SUMS else 1e-6)
        assert torch.equal(a, b), name
