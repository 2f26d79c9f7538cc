"""The port's occupant thermostat interaction against the JAX package's:
``core.step.occupant_update`` alone on states that make the increase and
the decrease trees fire, hold an override, count down and revert, and the
stepped ``tests/golden/quebec_occ`` district (two
``LogisticRegressionOccupantInteractionBuilding``s with real decision trees,
LSTM dynamics of two shapes, heating-side partial load, ComfortReward,
central agent) over 168 steps of ``district_step``.

Tolerances. ``occupant_update`` alone: exact — the set points are data plus
tree deltas, and the logistic probabilities only meet the uniform draws in
comparisons. The stepped district: as for the LSTM family (1e-5 of scale on
the physics and the state, 2e-4 |T| + 5e-3 on temperature, the LSTM carry
and the reward, at most 2 reward steps across a comfort threshold), and the
occupant's set points, overrides and counters exactly equal: a trigger is
decided by the temperature, and no step of this run lies within the
temperature's tolerance of a decision."""

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu.core.step import occupant_update as jax_occupant_update
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.step import OCC_FIELDS, district_step, occupant_update
from citylearn_tpu_torch.core.types import StepOutput, flatten

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "quebec_occ", "schema.json")
D, S = 2, 168


class Shim(NamedTuple):
    data_offset: jnp.ndarray
    occ_csp_override: jnp.ndarray
    occ_hsp_override: jnp.ndarray
    occ_hold_counter: jnp.ndarray
    occ_prev_temp: jnp.ndarray
    occ_prev_csp: jnp.ndarray
    occ_prev_hsp: jnp.ndarray


def jax_leaves(tree):
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", None)))
    return {".".join(name(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def golden():
    kw = dict(episode_time_steps=S + 1)
    cfg, params, _ = pack(compile_schema(GOLDEN, **kw), device="cpu")
    jcfg, jparams, _ = jax_pack(jax_compile(GOLDEN, **kw))
    return cfg, params, jcfg, jparams


def test_occupant_update_matches_jax(golden):
    cfg, params, jcfg, jparams = golden
    n, B = 96, cfg.n_buildings
    rng = np.random.RandomState(0)
    t = np.asarray([0, 5, 12, 40, 100, 150] * (n // 6), np.int32)
    off = np.asarray([0, 3] * (n // 2), np.int32)
    tau = off + t
    ser = params.series
    at = lambda arr: arr.numpy()[tau]
    temp = np.linspace(-20.0, 60.0, n * B, dtype=np.float32).reshape(n, B)
    mode = np.asarray([[2, 2], [1, 2], [2, 1], [3, 2]] * (n // 4), np.int32)
    set_ov = lambda: np.where(rng.uniform(size=(n, B)) < 0.4,
                              rng.uniform(17, 25, (n, B)), np.nan).astype(np.float32)
    state = dict(
        occ_csp_override=set_ov(), occ_hsp_override=set_ov(),
        occ_hold_counter=rng.choice([-1, 0, 1, 1, 3], (n, B)).astype(np.int32),
        occ_prev_temp=rng.uniform(15, 28, (n, B)).astype(np.float32),
        occ_prev_csp=rng.uniform(20, 27, (n, B)).astype(np.float32),
        occ_prev_hsp=rng.uniform(16, 23, (n, B)).astype(np.float32))
    csp, hsp = (at(getattr(ser, f"indoor_dry_bulb_temperature_{k}_set_point"))
                for k in ("cooling", "heating"))

    def one(st, c, h, m, tt, x):
        return jax_occupant_update(jcfg, jparams, jparams.series, st, c, h, m, x, tt, tt == 0,
                                   lambda v: v)
    ref = jax.jit(jax.vmap(one))(Shim(data_offset=jnp.asarray(off), **state), csp, hsp, mode,
                                 jnp.asarray(t), temp)
    T = lambda x: torch.tensor(x)
    ours = occupant_update(cfg, params, Shim(data_offset=T(off), **{k: T(v) for k, v in
                                                                   state.items()}),
                           T(csp), T(hsp), T(mode), T(temp), T(t))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    for k in OCC_FIELDS:
        np.testing.assert_array_equal(ours[2][k].numpy(), np.asarray(ref[2][k]), err_msg=k)
    # every branch was taken: an increase, a decrease, a hold counting down,
    # a reversion, and the warm-up gate holding a trigger back
    counter = ours[2]["occ_hold_counter"].numpy()
    fresh = counter == 4
    heating = mode == 2
    delta_h = ours[1].numpy() - np.where(np.isfinite(state["occ_hsp_override"]),
                                         state["occ_hsp_override"], hsp)
    assert (fresh & heating & (delta_h > 0)).any() and (fresh & heating & (delta_h < 0)).any()
    assert ((state["occ_hold_counter"] == 3) & (counter == 2)).any()
    reverted = (state["occ_hold_counter"] == 1) & (counter == -1)
    assert reverted.any() and np.isnan(ours[2]["occ_hsp_override"].numpy()[reverted]).all()
    assert not fresh[t < 12].any()


def assert_series_close(ours, ref, name, rtol=1e-5, atol=0.0, allow=0):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    bad = np.abs(ours - ref) > rtol * np.abs(ref) + rtol * scale + atol
    assert int(bad.sum()) <= allow, (name, int(bad.sum()), float(np.abs(ours - ref).max()))


def test_stepped_golden_district_matches_jax(golden):
    cfg, params, jcfg, jparams = golden
    B = cfg.n_buildings
    rng = np.random.RandomState(1)
    actions = np.zeros((D, S, 7, B), np.float32)
    # gentle heating: the occupants ask both for warmer and cooler set points
    actions[:, :, 5, :] = rng.uniform(0.0, 0.3, (D, S, B))       # heating_device
    actions[:, :, 3, :] = rng.uniform(-1.0, 1.0, (D, S, B))      # no battery: inert

    states = rollout.batched_initial_states(cfg, params, D, device="cpu")
    outs = []
    for s in range(S):
        states, out = district_step(
            cfg, params, states, rollout.actions_dict_from_array(torch.tensor(actions[:, s])))
        outs.append(out)
    ours = {f.name: torch.stack([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(StepOutput) if getattr(outs[0], f.name) is not None}

    def episode(state, acts):
        body = lambda st, a: jax_step(jcfg, jparams, st, jax_rollout.actions_dict_from_array(a))
        return jax.lax.scan(body, state, acts)

    jstates = jax_rollout.batched_initial_states(jcfg, jparams, D)
    jfinal, jouts = jax.jit(jax.vmap(episode))(jstates, jnp.asarray(actions))
    for k in ours:
        ref = np.swapaxes(np.asarray(getattr(jouts, k)), 0, 1)
        if k in ("cooling_set_point", "heating_set_point"):
            np.testing.assert_array_equal(ours[k].numpy(), ref, err_msg=k)
        elif k == "indoor_temperature":
            assert_series_close(ours[k], ref, k, rtol=2e-4, atol=5e-3)
        elif k == "reward":
            assert_series_close(ours[k], ref, k, rtol=2e-4, atol=5e-3, allow=2)
        else:
            assert_series_close(ours[k], ref, k)
    ref_state = jax_leaves(jfinal)
    for k, v in flatten(states).items():
        if k.startswith("occ_") and k != "occ_prev_temp":
            np.testing.assert_array_equal(v.numpy(), ref_state[k], err_msg=k)
            continue
        loose = k.split(".")[0] in ("lstm_h", "lstm_c", "dyn_input", "occ_prev_temp")
        assert_series_close(v.float(), ref_state[k].astype(np.float32), k,
                            rtol=2e-4 if loose else 1e-5)

    # the occupants acted: set points went up and down from the data, and
    # an override reverted to it
    data = params.series.indoor_dry_bulb_temperature_heating_set_point[:S, None]
    moved = ours["heating_set_point"] - data
    assert float(moved.max()) > 0.0 and float(moved.min()) < 0.0
    assert not moved[:12].any() and ((moved[:-1] != 0) & (moved[1:] == 0)).any()
    assert float(ours["heating_consumption"].max()) > 0.0


def test_final_row_past_the_data_raises(golden):
    """At t == 0 the occupant reads the episode's final row. Where a window
    runs one row past the data, ``jnp.take`` fills NaN in the JAX package
    while the port raises, as every read past the data's end does in it."""
    cfg, params, jcfg, jparams = golden
    n_rows = params.series.indoor_dry_bulb_temperature.shape[0]
    off = n_rows - cfg.time_steps + 1
    assert np.isnan(np.asarray(jnp.take(jparams.series.indoor_dry_bulb_temperature,
                                        off + jcfg.time_steps - 1, axis=0))).all()
    B = cfg.n_buildings
    f32 = lambda v: torch.full((1, B), v, dtype=torch.float32)
    state = Shim(data_offset=torch.tensor([off]), occ_csp_override=f32(float("nan")),
                 occ_hsp_override=f32(float("nan")),
                 occ_hold_counter=torch.full((1, B), -1, dtype=torch.int32),
                 occ_prev_temp=f32(20.0), occ_prev_csp=f32(24.0), occ_prev_hsp=f32(20.0))
    with pytest.raises(IndexError):
        occupant_update(cfg, params, state, f32(24.0), f32(20.0), f32(2.0), f32(21.0),
                        torch.tensor([0]))
