"""The port's stepped LSTM-dynamics district against the JAX package's:
168 steps of ``district_step`` at D=4 under per-district random actions
(cooling device, DHW and cooling storage, battery), every ``StepOutput``
field and the carried state, on the seeded synthetic dataset
(``citylearn_tpu_torch.synthetic.write_lstm_dataset``): decentral and
central agents, with power outages from the CSV, and the heterogeneous
district (two dynamics groups, one cooling tank) with outages.

Tolerances. Physics series and state: 1e-5 relative to each series'
scale, as for the other families (XLA:CPU contracts ``a + b * c`` where
the port rounds twice, and the SOCs carry the differences). The battery
acts within +-0.5: a discharge from above 80 % SOC is limited by the
capacity-power curve, whose slope of -4 multiplies a last-bit SOC
difference by 2.5 at every such step, and under +-1 a few such steps in a
row carry it past 1e-5. Temperature,
the LSTM's carry and input buffers, and the reward that reads the
temperature: 2e-4 relative plus 5e-3 absolute on temperature (the JAX
package's own tolerance between its kernel and its scan,
``tests/test_pallas_lstm.py``); a reward step may also sit across one of
the ComfortReward's thresholds from its counterpart, so at most 2 of the
168 x D x B reward steps may differ by more."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import rollout as jax_rollout
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.step import district_step as jax_step
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.types import StepOutput, flatten
from citylearn_tpu_torch.synthetic import write_lstm_dataset

D, S = 4, 168
LSTM_FIELDS = ("indoor_temperature", "reward")
CASES = {
    "decentral": (dict(), False),
    "central": (dict(), True),
    "outage": (dict(outage=True), False),
    "heterogeneous_outage": (dict(heterogeneous=True, outage=True), False),
}


def jax_leaves(tree):
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", None)))
    return {".".join(name(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_series_close(ours, ref, name, rtol=1e-5, atol=0.0, allow=0):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    bad = np.abs(ours - ref) > rtol * np.abs(ref) + rtol * scale + atol
    assert int(bad.sum()) <= allow, (name, int(bad.sum()), float(np.abs(ours - ref).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_lstm_steps_match_jax(tmp_path, case):
    writer_kw, central = CASES[case]
    path = write_lstm_dataset(str(tmp_path), n_rows=S + 32, seed=7, **writer_kw)
    kw = dict(central_agent=central, episode_time_steps=S + 1)
    cfg, params, _ = pack(compile_schema(path, **kw), device="cpu")
    jcfg, jparams, _ = jax_pack(jax_compile(path, **kw))
    B = cfg.n_buildings
    rng = np.random.RandomState(len(case))
    actions = np.zeros((D, S, 7, B), np.float32)
    for a, lo, hi in ((0, -1.0, 1.0), (2, -1.0, 1.0), (3, -0.5, 0.5), (4, 0.0, 1.0)):
        actions[:, :, a, :] = rng.uniform(lo, hi, (D, S, B))    # ACTION_KEYS order
    actions[0, 20:30] = 0.0                  # idle steps take the charging order

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
    assert ours["reward"].shape == (S, D, 1 if central else B)
    for k in ours:
        ref = np.swapaxes(np.asarray(getattr(jouts, k)), 0, 1)
        if k == "indoor_temperature":
            assert_series_close(ours[k], ref, k, rtol=2e-4, atol=5e-3)
        elif k == "reward":
            assert_series_close(ours[k], ref, k, rtol=2e-4, atol=5e-3, allow=2)
        else:
            assert_series_close(ours[k], ref, k)
    ref_state = jax_leaves(jfinal)
    for k, v in flatten(states).items():
        lstm = k.split(".")[0] in ("lstm_h", "lstm_c", "dyn_input")
        assert_series_close(v.float(), ref_state[k].astype(np.float32), k,
                            rtol=2e-4 if lstm else 1e-5)

    # the path was really taken: predictions leave the data temperature
    # after the warm-up and only then, partial load replaces the ideal
    # demand, the reward is the comfort reward of the prediction
    ideal = params.series.indoor_dry_bulb_temperature[:S, None]
    moved = (ours["indoor_temperature"] - ideal).abs()
    assert float(moved[:12].max()) == 0.0 and float(moved[12:].max()) > 0.5
    demand = params.series.cooling_demand[:S, None].expand(S, D, B)
    assert torch.equal(ours["cooling_demand_actual"][:13], demand[:13])
    assert not torch.equal(ours["cooling_demand_actual"][13:], demand[13:])
    assert float(ours["reward"].max()) <= 0.0 and float(ours["reward"].min()) < -1.0
    assert float(ours["heating_consumption"].abs().max()) == 0.0
    assert not torch.equal(ours["indoor_temperature"][:, 0], ours["indoor_temperature"][:, 1])
    if cfg.any_outage:
        out = params.series.power_outage[:S, None].expand(S, D, B) > 0
        assert out.any()
        assert float(ours["net_electricity_consumption"][out].abs().max()) == 0.0
        nsl = params.series.non_shiftable_load[:S, None].expand(S, D, B)
        assert (ours["non_shiftable_load_met"][out] < nsl[out] - 1e-6).any()
        # a charging battery is capped by what the sun leaves; a discharging
        # one serves the loads
        assert (ours["battery_balance"][out] < 0).any()
    if "heterogeneous" in case:
        assert len(cfg.dyn_groups) == 2 and len(states.lstm_h) == 2
        cbal = ours["cooling_storage_balance"]
        assert (cbal[..., 1] > 0).any() and (cbal[..., 1] < 0).any()
        assert float(cbal[..., 0].abs().max()) == 0.0
