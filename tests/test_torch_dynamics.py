"""The pieces of the LSTM-dynamics step against the JAX package's, each
on seeded numpy inputs under ``jax.jit``: ``lstm_predict`` (one and two
layers), ``dynamics_update`` (before, at and after the warm-up step, with
the one-step-older temperature channel), the ComfortReward over all its
branches and its mix with the SolarPenaltyReward, and the partial-load
override (cooling and heating devices, and the combined device).

Tolerance: 1e-6 relative to each output's scale, plus 1e-6 absolute. One
LSTM window is at most 24 cells deep; the two packages sum the gate
products in another order (``einsum`` here, ``dot_general`` under XLA) and
XLA:CPU fuses ``a + b * c``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import reward as jax_reward
from citylearn_tpu.core.dynamics import lstm_predict as jax_lstm_predict
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu.core.step import dynamics_update as jax_dynamics_update
from citylearn_tpu.core.types import DynamicsParams as JaxDynamicsParams
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import reward
from citylearn_tpu_torch.core.dynamics import lstm_predict
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.step import district_step, dynamics_update
from citylearn_tpu_torch.core.types import DynamicsParams
from citylearn_tpu_torch.synthetic import write_lstm_dataset

D = 3


def assert_close(ours, ref, name, tol=1e-6):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale, err_msg=name)


def random_dynamics(rng, n, H, L, F=12):
    """One dynamics group of ``n`` buildings as numpy leaves."""
    u = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return dict(
        member_indices=np.arange(n, dtype=np.int32),
        w_ih=tuple(u(n, 4 * H, F if l == 0 else H) for l in range(L)),
        w_hh=tuple(u(n, 4 * H, H) for l in range(L)),
        bias=tuple(u(n, 4 * H) for l in range(L)),
        lin_w=u(n, H), lin_b=u(n),
        norm_min=u(n, F) - 1.0, norm_max=u(n, F) + 1.0,
        static_channels=u(40, n, F),
        cooling_device_active=np.ones(n, bool), heating_device_active=np.zeros(n, bool),
        cooling_or_heating_active=np.zeros(n, bool))


def both_dynamics(leaves):
    t = lambda v: tuple(torch.tensor(x) for x in v) if isinstance(v, tuple) else torch.tensor(v)
    j = lambda v: tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v)
    return (DynamicsParams(**{k: t(v) for k, v in leaves.items()}),
            JaxDynamicsParams(**{k: j(v) for k, v in leaves.items()}))


@pytest.mark.parametrize("H,L", [(8, 2), (50, 1), (24, 2)])
def test_lstm_predict_matches_jax(H, L):
    rng = np.random.RandomState(H + L)
    n, lookback, F = 4, 12, 12
    dyn, jdyn = both_dynamics(random_dynamics(rng, n, H, L, F))
    x = rng.uniform(-1, 1, (D, n, lookback, F)).astype(np.float32)
    h0, c0 = (rng.uniform(-0.5, 0.5, (D, L, n, H)).astype(np.float32) for _ in range(2))
    pred, h, c = lstm_predict(dyn, torch.tensor(x), torch.tensor(h0), torch.tensor(c0))
    ref = jax.jit(jax.vmap(lambda x, h, c: jax_lstm_predict(jdyn, x, h, c)))(x, h0, c0)
    assert pred.shape == (D, n) and h.shape == (D, L, n, H)
    for name, a, b in zip(("pred", "h", "c"), (pred, h, c), ref):
        assert_close(a, b, name)


@pytest.mark.parametrize("t", [3, 12, 20], ids=["cold", "first_warm", "warm"])
def test_dynamics_update_matches_jax(t):
    """Two groups (8 units in two layers, 50 in one) over four buildings:
    the returned temperature, the carried (h, c) and the input buffers."""
    rng = np.random.RandomState(t)
    lookback, F, tc, cc = 12, 12, 11, 4
    shapes = ((8, 2, [0, 1, 3]), (50, 1, [2]))
    dyns, jdyns, metas = [], [], []
    for H, L, members in shapes:
        leaves = random_dynamics(rng, len(members), H, L, F)
        leaves["member_indices"] = np.asarray(members, np.int32)
        d, jd = both_dynamics(leaves)
        dyns.append(d), jdyns.append(jd), metas.append((lookback, L, H, F, tc, cc, -1))
    base = pack_default()
    cfg = dataclasses.replace(base[0][0], n_buildings=4, dyn_groups=tuple(metas))
    jcfg = dataclasses.replace(base[1][0], n_buildings=4, dyn_groups=tuple(metas))
    params = dataclasses.replace(base[0][1], dynamics=tuple(dyns))
    jparams = base[1][1].replace(dynamics=tuple(jdyns))
    f = lambda *shape: rng.uniform(0, 3, shape).astype(np.float32)
    cool, heat, temp = f(D, 4), f(D, 4), f(D, 4) + 20
    h = [rng.uniform(-.5, .5, (D, L, len(m), H)).astype(np.float32) for H, L, m in shapes]
    c = [rng.uniform(-.5, .5, (D, L, len(m), H)).astype(np.float32) for H, L, m in shapes]
    buf = [rng.uniform(0, 1, (D, len(m), F, lookback + 1)).astype(np.float32)
           for H, L, m in shapes]
    tt = lambda xs: tuple(torch.tensor(x) for x in xs)
    ours = dynamics_update(cfg, params, torch.full((D,), t + 2), torch.full((D,), t),
                           torch.tensor(cool), torch.tensor(heat), torch.tensor(temp),
                           tt(h), tt(c), tt(buf))
    one = lambda cool, heat, temp, h, c, buf: jax_dynamics_update(
        jcfg, jparams, t + 2, t, cool, heat, temp, h, c, buf)
    ref = jax.jit(jax.vmap(one))(cool, heat, temp, tuple(h), tuple(c), tuple(buf))
    assert_close(ours[0], ref[0], "temperature")
    for name, a, b in zip(("h", "c", "buffer"), ours[1:], ref[1:]):
        for g in range(2):
            assert_close(a[g], b[g], f"{name}[{g}]")
    warm = t >= lookback
    # the carry and the temperature move only once the window is full
    assert torch.equal(ours[1][0], torch.tensor(h[0])) != warm
    assert torch.equal(ours[0], torch.tensor(temp)) != warm
    # the newest column holds the normalized inputs, the temperature entry
    # the prediction once warm; older columns shift by one
    assert torch.equal(ours[3][0][..., :-1], torch.tensor(buf[0])[..., 1:])
    norm_t = (torch.tensor(temp)[:, [0, 1, 3]] - dyns[0].norm_min[:, tc]) \
        / (dyns[0].norm_max[:, tc] - dyns[0].norm_min[:, tc])
    assert torch.equal(ours[3][0][:, :, tc, -1], norm_t) != warm


_PACKED = {}


def pack_default(tmp=None):
    """The default synthetic district packed by both packages (cached)."""
    if not _PACKED:
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            path = write_lstm_dataset(root, n_rows=100, seed=3)
            _PACKED["v"] = (pack(compile_schema(path), device="cpu")[:2],
                            jax_pack(jax_compile(path))[:2])
    return _PACKED["v"]


@pytest.mark.parametrize("band,lo,hi", [(None, 2.0, 2.0), (1.5, 2.0, 3.0), (2.0, 1.0, 2.5)])
def test_comfort_reward_matches_jax_on_every_branch(band, lo, hi):
    rng = np.random.RandomState(0)
    n, B = 4000, 3
    f = lambda lo_, hi_: rng.uniform(lo_, hi_, (n, B)).astype(np.float32)
    T, csp, hsp = f(14, 32), f(22, 27), f(18, 23)
    mode = rng.randint(0, 4, (n, B)).astype(np.int32)
    cool, heat = f(0, 2), f(0, 2) * (rng.rand(n, B) < 0.5)
    bands = f(0.5, 3.0)
    zero = np.zeros((n, B), np.float32)
    kw = dict(net=zero, solar=zero, battery_soc=zero, cooling_storage_soc=zero,
              heating_storage_soc=zero, dhw_storage_soc=zero, battery_capacity=zero[0],
              cooling_storage_capacity=zero[0], heating_storage_capacity=zero[0],
              dhw_storage_capacity=zero[0], indoor_temperature=T, hvac_mode=mode,
              cooling_set_point=csp, heating_set_point=hsp, comfort_band=bands,
              cooling_demand=cool, heating_demand=heat)
    cfg, jcfg = (dataclasses.replace(c, reward_band=band, reward_lower_exponent=lo,
                                     reward_higher_exponent=hi)
                 for c in (pack_default()[0][0], pack_default()[1][0]))
    x = reward.RewardInputs(**{k: torch.tensor(v) for k, v in kw.items()})
    jx = jax_reward.RewardInputs(**{k: jnp.asarray(v) for k, v in kw.items()})
    ours = reward._comfort(cfg, x)
    ref = jax.jit(lambda x: jax_reward._comfort(jcfg, x))(jx)
    assert_close(ours, ref, "comfort")
    # every branch of both set-point forms, for heating and cooling loads
    b = bands if band is None else np.full_like(T, band)
    heating = heat > cool
    for single in (True, False):
        sp = np.where(mode == 1, csp, hsp)
        regions = ([T < sp - b, (T >= sp - b) & (T < sp), (T >= sp) & (T <= sp + b), T > sp + b]
                   if single else
                   [T < hsp - b, (T >= hsp - b) & (T < hsp), (T >= hsp) & (T <= csp),
                    (T > csp) & (T < csp + b), (T >= csp + b) & (T > csp)])
        in_form = ((mode == 1) | (mode == 2)) == single
        for region in regions:
            for load in (heating, ~heating):
                assert (in_form & region & load).any()
    # the reward registry serves it, summed for a central agent, and mixed
    central = dataclasses.replace(cfg, central_agent=True)
    assert torch.equal(reward.compute_reward(central, x), ours.sum(-1, keepdim=True))
    mixed = dataclasses.replace(cfg, reward_type="SolarPenaltyAndComfortReward",
                                reward_coefficients=(0.5, 2.0))
    jmixed = dataclasses.replace(jcfg, reward_type="SolarPenaltyAndComfortReward",
                                 reward_coefficients=(0.5, 2.0))
    kw["net"], kw["battery_capacity"] = f(-2, 4), np.full(B, 6.4, np.float32)
    kw["battery_soc"] = f(0, 1)
    x = reward.RewardInputs(**{k: torch.tensor(v) for k, v in kw.items()})
    jx = jax_reward.RewardInputs(**{k: jnp.asarray(v) for k, v in kw.items()})
    ref = jax.jit(jax.vmap(lambda x: jax_reward.compute_reward(jmixed, x), in_axes=(
        jax_reward.RewardInputs(**{k: (None if v.ndim == 1 else 0) for k, v in kw.items()}),)))(jx)
    assert_close(reward.compute_reward(mixed, x), ref, "mixed")


@pytest.mark.parametrize("combined", [False, True], ids=["two_devices", "combined_device"])
def test_partial_load_override_matches_jax(combined):
    """One step after the warm-up of a district given a heating device:
    the controlled cooling and heating demands under device actions, for
    separate cooling/heating actions and for the signed combined action;
    and the ideal demands while the window fills."""
    (cfg, params), (jcfg, jparams) = pack_default()
    B = cfg.n_buildings
    rng = np.random.RandomState(int(combined))
    nominal = rng.uniform(1.0, 3.0, B).astype(np.float32)
    flags = dict(cooling_device_active=np.array([not combined] * B),
                 heating_device_active=np.array([not combined, False, not combined]),
                 cooling_or_heating_active=np.array([combined] * B))
    params = dataclasses.replace(
        params,
        heating_device=dataclasses.replace(params.heating_device,
                                           nominal_power=torch.tensor(nominal)),
        dynamics=(dataclasses.replace(params.dynamics[0], **{
            k: torch.tensor(v) for k, v in flags.items()}),))
    jparams = jparams.replace(
        heating_device=jparams.heating_device.replace(nominal_power=jnp.asarray(nominal)),
        dynamics=(jparams.dynamics[0].replace(**{k: jnp.asarray(v) for k, v in flags.items()}),))
    actions = {"cooling_device": rng.uniform(0, 1, (D, B)), "heating_device": rng.uniform(0, 1, (D, B)),
               "cooling_or_heating_device": rng.uniform(-1, 1, (D, B)),
               "electrical_storage": rng.uniform(-1, 1, (D, B))}
    actions = {k: v.astype(np.float32) for k, v in actions.items()}
    jstep = jax.jit(jax.vmap(lambda st, a: jax_step(jcfg, jparams, st, a)))
    for t in (5, 13, 40, 60, 85):        # window filling, then days of modes 1, 3 and 2
        state = batched_initial_states(cfg, params, D, device="cpu")
        state = dataclasses.replace(state, t=torch.full((D,), t, dtype=torch.int32))
        _, out = district_step(cfg, params, state, {k: torch.tensor(v) for k, v in actions.items()})
        jstate = jax_initial_state(jcfg, jparams)
        jstate = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (D,) + x.shape), jstate)
        jstate = jstate.replace(t=jnp.full((D,), t, jnp.int32))
        _, jout = jstep(jstate, {k: jnp.asarray(v) for k, v in actions.items()})
        for name in ("cooling_demand_actual", "heating_demand_actual", "cooling_demand_met",
                     "heating_demand_met", "net_electricity_consumption", "reward",
                     "indoor_temperature"):
            assert_close(getattr(out, name), getattr(jout, name), f"{name} at t={t}")
        ideal = params.series.cooling_demand[t]
        assert torch.equal(out.cooling_demand_actual, ideal.expand(D, B)) == (t <= 12)
        if t > 12 and int(params.series.hvac_mode[t, 0]) in (2, 3):
            assert float(out.heating_demand_actual[:, 0].max()) > 0.0
            assert float(out.heating_demand_actual[:, 1].max()) == 0.0 or combined
