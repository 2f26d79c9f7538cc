"""The port's compiler and packer on LSTM-dynamics districts against the
JAX package's: the compiled spec (dynamics block, outage flags,
observation/action surface), ``_load_dynamics``, the packed leaves, the
static configuration, the initial state and the baked stochastic-outage
signal, on the seeded synthetic dataset
(``citylearn_tpu_torch.synthetic.write_lstm_dataset``) in its four shapes:
default, heterogeneous, with outages from the CSV, with a stochastic outage
model. Everything here is exact: both packages run the same numpy code on
the same files. Also the writer's guarantees and its determinism."""

import dataclasses
import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import rollout_fast as jax_rollout_fast
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.params import rebake_outage as jax_rebake_outage
from citylearn_tpu_torch.compiler.schema import _load_dynamics, compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import initial_state, pack, params_from_numpy, rebake_outage
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.step import check_supported
from citylearn_tpu_torch.core.types import flatten
from citylearn_tpu_torch.synthetic import LSTM_INPUTS, write_lstm_dataset

N_ROWS = 800
# the stochastic model draws whole days: its episode is 7 days of 24 steps
VARIANTS = {
    "default": (dict(), dict(episode_time_steps=169)),
    "central": (dict(), dict(episode_time_steps=169, central_agent=True)),
    "heterogeneous": (dict(heterogeneous=True), dict(episode_time_steps=169)),
    "outage": (dict(outage=True), dict(episode_time_steps=169)),
    "stochastic": (dict(stochastic_outage=True), dict(episode_time_steps=168)),
}
#: packed parameter leaves: 61 of a district without dynamics plus, per
#: group, 9 leaves and 3 per layer
N_LEAVES = {"default": 76, "central": 76, "heterogeneous": 88, "outage": 76, "stochastic": 76}


def jax_leaves(tree):
    """{"field.0.subfield": numpy array} of a JAX pytree of dataclasses
    and tuples."""
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", None)))
    return {".".join(name(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    out = {}
    for name, (writer_kw, compile_kw) in VARIANTS.items():
        path = write_lstm_dataset(str(tmp_path_factory.mktemp(name)), n_rows=N_ROWS, seed=2,
                                  **writer_kw)
        out[name] = (path, compile_schema(path, **compile_kw), jax_compile(path, **compile_kw))
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spec_equals_jax(compiled, variant):
    _, spec, jspec = compiled[variant]
    assert len(spec.buildings) == len(jspec.buildings)
    for b, jb in zip(spec.buildings, jspec.buildings):
        assert b.active_observations == jb.active_observations
        assert b.active_actions == jb.active_actions and "cooling_device" in b.active_actions
        assert b.observation_low == jb.observation_low
        assert b.observation_high == jb.observation_high
        assert (b.action_low, b.action_high) == (jb.action_low, jb.action_high)
        assert (b.simulate_power_outage, b.stochastic_power_outage,
                b.stochastic_power_outage_model) == (
            jb.simulate_power_outage, jb.stochastic_power_outage,
            jb.stochastic_power_outage_model)
        d, jd = b.dynamics, jb.dynamics
        for f in dataclasses.fields(d):
            ours, ref = getattr(d, f.name), getattr(jd, f.name)
            if isinstance(ours, list) and ours and isinstance(ours[0], np.ndarray):
                assert len(ours) == len(ref) == d.num_layers
                for x, y in zip(ours, ref):
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
            elif isinstance(ours, np.ndarray):
                np.testing.assert_array_equal(ours, ref, err_msg=f.name)
            else:
                assert ours == ref, f.name
        for k, v in b.series.items():
            np.testing.assert_array_equal(v, jb.series[k], err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pack_equals_jax(compiled, variant):
    _, spec, jspec = compiled[variant]
    cfg, params, layout = pack(spec, device="cpu")
    jcfg, jparams, jlayout = jax_pack(jspec)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.has_dynamics and cfg.any_cooling and cfg.any_heating and cfg.max_lookback == 12
    assert cfg.any_outage == (variant in ("outage", "stochastic"))
    assert cfg.has_stochastic_outage == (variant == "stochastic")
    assert len(cfg.dyn_groups) == (2 if variant == "heterogeneous" else 1)
    check_supported(cfg)
    assert layout.union_names == jlayout.union_names
    assert layout.building_indices == jlayout.building_indices
    carried = flatten(params_from_numpy(jax_leaves(jparams), device="cpu"))
    ours = flatten(params)
    assert set(ours) == set(carried) and len(ours) == N_LEAVES[variant]
    for k, v in ours.items():
        assert v.dtype == carried[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), carried[k].numpy(), err_msg=k)
    assert torch.isfinite(params.dynamics[0].static_channels).all()
    assert rollout_fast.eligible_lstm(cfg) == jax_rollout_fast.eligible_lstm(jcfg) is True
    assert rollout_fast.lstm_packable(cfg, params) \
        == jax_rollout_fast.lstm_packable(jcfg, jparams) is True
    # the episode's first week holds outage steps on both kinds of district
    if cfg.any_outage:
        assert float(params.series.power_outage[:168].sum()) > 0


@pytest.mark.parametrize("variant", ["default", "heterogeneous"])
def test_initial_state_equals_jax(compiled, variant):
    _, spec, jspec = compiled[variant]
    cfg, params, _ = pack(spec, device="cpu")
    jcfg, jparams, _ = jax_pack(jspec)
    ours = flatten(initial_state(cfg, params, 5))
    ref = jax_leaves(jax_initial_state(jcfg, jparams, 5))
    # 18 leaves of a district without dynamics (6 of them the zero-sized
    # occupant carry) and 3 per group
    assert len(ours) == 18 + 3 * len(cfg.dyn_groups)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    lookback, L, H, F = cfg.dyn_groups[-1][:4]
    batched = batched_initial_states(cfg, params, 3, device="cpu")
    n = params.dynamics[-1].member_indices.shape[0]
    assert batched.lstm_h[-1].shape == (3, L, n, H)
    assert batched.dyn_input[-1].shape == (3, n, F, lookback + 1)


def test_stochastic_outage_is_baked_and_rebaked_as_in_jax(compiled):
    _, spec, jspec = compiled["stochastic"]
    cfg, params, _ = pack(spec, device="cpu")
    jcfg, jparams, _ = jax_pack(jspec)
    signal = params.series.power_outage.numpy()
    np.testing.assert_array_equal(signal, np.asarray(jparams.series.power_outage))
    assert signal[:168].sum() > 0 and signal[168:].sum() == 0      # the default window only
    # the outage observation stays zero: the signal is resolved per episode
    col = pack(spec, device="cpu")[2].column("power_outage")
    assert float(params.obs_static[:, :, col].abs().max()) == 0.0
    rebaked = rebake_outage(spec, cfg, params, 48)
    ref = jax_rebake_outage(jspec, jcfg, jparams, 48)
    np.testing.assert_array_equal(rebaked.series.power_outage.numpy(),
                                  np.asarray(ref.series.power_outage))
    assert float(rebaked.series.power_outage[:48].sum()) == 0.0
    assert rebake_outage(spec, cfg, params, 0) is params
    # a shifted window without the rebaked signal is refused
    with pytest.raises(ValueError, match="rebake"):
        batched_initial_states(cfg, params, 2, data_offset=48, device="cpu")
    batched_initial_states(cfg, rebaked, 2, data_offset=48, device="cpu", outage_rebaked=True)
    with pytest.raises(ValueError, match="rebake"):
        evaluate_scripted(cfg, params, ScriptedPolicy({}), data_offset=48, device="cpu")


def test_load_dynamics_reads_the_state_dict(tmp_path):
    path = write_lstm_dataset(str(tmp_path), n_rows=48, heterogeneous=True)
    with open(path) as f:
        schema = json.load(f)
    for name, hidden, layers in (("Building_1", 8, 2), ("Building_4", 50, 1)):
        block = schema["buildings"][name]["dynamics"]
        d = _load_dynamics(block, str(tmp_path))
        state = torch.load(tmp_path / f"{name}.pth", weights_only=False)
        assert set(state) == {f"l_lstm.{k}_l{l}" for l in range(layers) for k in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")} | {"l_linear.weight",
                                                                 "l_linear.bias"}
        assert (d.hidden_size, d.num_layers, d.lookback) == (hidden, layers, 12)
        assert d.input_observation_names == LSTM_INPUTS
        assert d.w_ih[0].shape == (4 * hidden, 12) and d.w_hh[0].shape == (4 * hidden, hidden)
        np.testing.assert_array_equal(
            d.bias[0], (state["l_lstm.bias_ih_l0"] + state["l_lstm.bias_hh_l0"]).numpy())
        np.testing.assert_array_equal(d.lin_w, state["l_linear.weight"].numpy().ravel())
        assert d.lin_b == float(state["l_linear.bias"][0])
        assert (d.norm_max > d.norm_min).all()


def test_writer_guarantees(tmp_path):
    """What the other LSTM tests rely on: the modes, the set points on
    both sides of the data temperature, outage events by day and by night
    inside the first week, no heating end use, one cooling tank."""
    path = write_lstm_dataset(str(tmp_path), n_rows=N_ROWS, outage=True, heterogeneous=True)
    spec = compile_schema(path)
    cfg, params, _ = pack(spec, device="cpu")
    assert cfg.n_buildings == 4 and cfg.reward_type == "ComfortReward"
    assert (cfg.reward_band, cfg.reward_lower_exponent, cfg.reward_higher_exponent) \
        == (2.0, 2.0, 3.0)
    ser = params.series
    mode = ser.hvac_mode[:168, 0].numpy()
    assert set(np.unique(mode)) == {0, 1, 2, 3} and (mode == 1).mean() > 0.5
    assert float(ser.heating_demand.max()) == 0.0
    assert float(params.heating_storage.capacity.max()) == 0.0
    assert (params.cooling_storage.capacity > 0).tolist() == [False, True, False, False]
    assert [b.active_actions for b in spec.buildings][1] == [
        "cooling_storage", "dhw_storage", "electrical_storage", "cooling_device"]
    assert "cooling_storage" not in spec.buildings[0].active_actions
    out = ser.power_outage[:168]
    hour = ser.hour[:168]
    assert out.sum(0).min() >= 9                          # three events per building
    assert ((out > 0) & (hour >= 10) & (hour <= 16)).any() and ((out > 0) & (hour <= 6)).any()
    assert (out[1:] != out[:-1]).sum(0).min() >= 6        # several separate events
    indoor, csp, hsp = (getattr(ser, f"indoor_dry_bulb_temperature{s}") for s in (
        "", "_cooling_set_point", "_heating_set_point"))
    assert (indoor < csp).any() and (indoor > csp).any()
    assert (indoor < hsp).any() and (indoor > hsp).any()
    assert float(ser.occupant_count.min()) >= 1.0


def _digest(root):
    h = hashlib.sha256()
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()


@pytest.mark.parametrize("kw", [dict(), dict(heterogeneous=True), dict(outage=True),
                                dict(stochastic_outage=True)],
                         ids=["default", "heterogeneous", "outage", "stochastic"])
def test_writer_is_deterministic(tmp_path, kw):
    a, b, c = (tmp_path / x for x in "abc")
    for root in (a, b):
        write_lstm_dataset(str(root), n_rows=96, seed=4, **kw)
    write_lstm_dataset(str(c), n_rows=96, seed=5, **kw)
    assert _digest(a) == _digest(b) != _digest(c)


def test_occupants_still_raise(tmp_path):
    """Of the two blocks this family once refused, the float64 parity mode
    still raises; an occupant block now compiles (an occupant whose
    parameter file is missing fails on the file) and steps."""
    path = write_lstm_dataset(str(tmp_path), n_rows=48)
    with open(path) as f:
        schema = json.load(f)
    schema["root_directory"] = str(tmp_path)
    b = schema["buildings"]["Building_1"]
    b["type"] = "citylearn.building.LogisticRegressionOccupantInteractionBuilding"
    b["occupant"] = {"type": "citylearn.occupant.LogisticRegressionOccupant",
                     "parameters_filename": "missing.csv"}
    with pytest.raises(FileNotFoundError, match="missing.csv"):
        compile_schema(schema)
    cfg = pack(compile_schema(path), device="cpu")[0]
    check_supported(dataclasses.replace(cfg, has_occupant=True))
    with pytest.raises(NotImplementedError, match="parity_f64"):
        check_supported(dataclasses.replace(cfg, parity_f64=True))
