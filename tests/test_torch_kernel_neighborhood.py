"""K6, the whole-episode neighborhood kernel, on the CPU: its plain version
(``ops.neighborhood.neighborhood_episode_reference``) against the JAX
package's Pallas kernel run in interpret mode
(``citylearn_tpu/ops/pallas_neighborhood.py::neighborhood_episode``, its
TPU padding done here), on the EULP shape and the quebec shape of
``citylearn_tpu_torch.synthetic.write_neighborhood_dataset`` from
per-district seeded states: the 7 outputs and the 9 recorded rows. Then a
district without a battery against the stepped path's null battery;
``eligible_neighborhood``, ``neighborhood_packable`` and ``kernel_family``
against the JAX package's on every synthetic writer and
``tests/golden/quebec_occ``; the writers' files against the ones the earlier
writers wrote; the wrapper's rejections. The kernel's split into a prelude
shared by every district and a district pass is held bit-equal to the
plain version through the two halves' plain versions.

Tolerance: 1e-5 of each output's scale, as for K1-K5 (XLA:CPU contracts
``a + b * c`` into one fused multiply-add where the port rounds twice).
The kernel itself runs on the card only (the ``gpu`` test below); there it
is held bit-equal to the plain version."""

import dataclasses
import hashlib
import os
import warnings

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import evaluate_fast, rollout_fast
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.ops import neighborhood as k6
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_lstm_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "quebec_occ", "schema.json")
S, D, LANES = 168, 256, 128
WEEK = 2952
HRS = np.arange(1, 25)
PLANS = {"cooling_or_heating_device": np.where(HRS < 12, 0.6, -0.5).astype(np.float32),
         "heating_device": np.where(HRS < 8, 0.9, 0.4).astype(np.float32),
         "electrical_storage": np.where(HRS < 9, 0.091, -0.08).astype(np.float32)}


@pytest.fixture(scope="module")
def districts(tmp_path_factory):
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the quebec shape's missing trees
        for name, quebec in (("eulp", False), ("quebec", True)):
            path = write_neighborhood_dataset(str(tmp_path_factory.mktemp(name)), 6, 8760,
                                              seed=5, quebec=quebec)
            # a week in late May, where hvac_mode goes from 3 to 1
            out[name] = (path, pack(compile_schema(path, simulation_start_time_step=WEEK,
                                                   episode_time_steps=S + 1),
                                    device="cpu")[:2])
    return out


def seeded_inputs(cfg, params, seed=0, n_districts=D):
    """K6's inputs at ``n_districts`` districts with states that differ
    from district to district."""
    inputs = rollout_fast.neighborhood_episode_inputs(cfg, params, n_districts, PLANS)
    rng = np.random.RandomState(seed)
    B = cfg.n_buildings
    rand = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (n_districts, B)).astype(np.float32))
    inputs.update(dsoc0=rand(0.0, 1.0), soc0=rand(0.0, 1.0), eff0=rand(0.85, 0.95),
                  deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous())
    return inputs


def jax_episode(inputs, record=True):
    """The JAX package's Pallas kernel in interpret mode on the same
    inputs, with its TPU padding: steps to a multiple of its chunk,
    buildings to one lane tile."""
    import jax.numpy as jnp

    from citylearn_tpu.ops import pallas_neighborhood as pn

    B = inputs["nparams"].shape[1]
    t_pad = (S + pn.T_CHUNK - 1) // pn.T_CHUNK * pn.T_CHUNK
    lanes = lambda x: np.concatenate(
        [x, np.repeat(x[..., :1], LANES - B, axis=-1)], axis=-1).astype(np.float32)
    stream = lambda x: jnp.asarray(np.pad(lanes(x.numpy()), ((0, t_pad - S), (0, 0))))
    out = pn.neighborhood_episode(
        tuple(stream(x) for x in inputs["actions"]), tuple(stream(x) for x in inputs["series"]),
        jnp.asarray(lanes(inputs["bparams"].numpy())),
        tuple(jnp.asarray(lanes(c.numpy())) for c in inputs["curves"]),
        jnp.asarray(lanes(inputs["nparams"].numpy())),
        *(jnp.asarray(lanes(inputs[k].numpy())) for k in ("dsoc0", "soc0", "eff0", "deg0")),
        n_steps=S, hours_ratio=inputs["hours_ratio"], ratio=inputs["ratio"],
        n_knots=inputs["curves"][0].shape[0], lookback=inputs["lookback"], record=record,
        interpret=True)
    sliced = tuple(np.asarray(o)[:, :B] for o in out[:7])
    return sliced + ((np.asarray(out[7])[:, :S, :B],) if record else ())


def assert_close(ours, ref, name, rtol=1e-5):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    err = float(np.max(np.abs(ours - ref), initial=0.0))
    assert err <= rtol * scale, (name, err, scale)


@pytest.mark.parametrize("name", ["eulp", "quebec"])
def test_plain_version_matches_pallas_interpret(districts, name):
    _, (cfg, params) = districts[name]
    inputs = seeded_inputs(cfg, params)
    ours = k6.neighborhood_episode(**inputs, record=True)
    ref = jax_episode(inputs)
    names = ("reward", "cost", "emission", "dhw_soc", "soc", "eff", "deg")
    for n, a, b in zip(names, ours[:7], ref[:7]):
        assert_close(a, b, n)
    for row in range(k6.N_NREC):
        assert_close(ours[7][row], ref[7][row], f"row {row}")
    rec = ours[7]
    # the physics ran: partial load replaced the data's demand after the
    # warm-up and never before, the DHW tank only lost charge
    lookback = inputs["lookback"]
    cool_d, heat_d = inputs["series"][4], inputs["series"][5]
    assert torch.equal(rec[k6.R_HDEM][:lookback + 1], heat_d[:lookback + 1])
    assert not torch.equal(rec[k6.R_HDEM][lookback + 1:], heat_d[lookback + 1:])
    assert (rec[k6.R_DSOC][1:] <= rec[k6.R_DSOC][:-1]).all()
    assert float(rec[k6.R_HOUT].max()) > 0.0
    if name == "eulp":
        assert not torch.equal(rec[k6.R_CDEM][lookback + 1:], cool_d[lookback + 1:])
        assert (rec[k6.R_BBAL] > 0).any() and (rec[k6.R_BBAL] < 0).any()
        # a heating device that is not a heat pump books through the DHW
        # device's efficiency
        assert (inputs["nparams"][k6.HHP] < 0.5).any()
        assert set(inputs["series"][8][:, 0].tolist()) == {0.0, 1.0, 3.0}
        assert not torch.equal(ours[1][0], ours[1][1])
    assert not torch.equal(ours[3][0], ours[3][1])


@pytest.mark.parametrize("name", ["eulp", "quebec"])
def test_prelude_and_district_pass_rebuild_the_plain_version(districts, name):
    """What every district shares (the prelude) and what each district
    carries (the district pass), composed, equal the plain version bit for
    bit: outputs and all nine rows."""
    _, (cfg, params) = districts[name]
    inputs = seeded_inputs(cfg, params, seed=2, n_districts=37)
    full = k6.neighborhood_episode_reference(**inputs, record=True)
    pre, shared_rows = k6.neighborhood_prelude_reference(
        inputs["actions"], inputs["series"], inputs["nparams"], inputs["hours_ratio"],
        inputs["lookback"])
    assert pre.shape == (S, cfg.n_buildings)
    assert shared_rows.shape == (k6.N_NREC - k6.N_DISTRICT_REC, S, cfg.n_buildings)
    out = k6.neighborhood_district_reference(
        pre, inputs["series"][1:4], inputs["actions"][3], inputs["bparams"], inputs["curves"],
        inputs["nparams"], inputs["dsoc0"], inputs["soc0"], inputs["eff0"], inputs["deg0"],
        inputs["hours_ratio"], inputs["ratio"], record=True)
    rec = torch.cat([out[7], shared_rows])
    for a, b in zip(out[:7] + (rec,), full):
        assert torch.equal(a, b)
    assert not torch.equal(out[3][0], out[3][1])          # the DHW tanks differ


def test_null_battery_matches_the_stepped_path(districts):
    """The quebec shape has no battery: capacity and power 0. K6's battery
    stays at 0 with finite outputs, as the stepped path's does."""
    _, (cfg, params) = districts["quebec"]
    assert float(params.battery.capacity.abs().max()) == 0.0
    inputs = rollout_fast.neighborhood_episode_inputs(cfg, params, 3, PLANS, n_steps=48)
    out = k6.neighborhood_episode(**inputs, record=True)
    assert all(torch.isfinite(x).all() for x in out)
    assert float(out[7][k6.R_BBAL].abs().max()) == 0.0
    states = batched_initial_states(cfg, params, 3, device="cpu")
    plans = evaluate_fast.ScriptedPolicy(PLANS).as_policy_fn(cfg, params, 48)
    for _ in range(48):
        states, step = district_step(cfg, params, states, plans(params, states))
        assert float(step.battery_balance.abs().max()) == 0.0
    for ours, stepped in ((out[4], states.battery_soc), (out[5], states.battery_efficiency),
                          (out[6], states.battery_degraded_capacity)):
        assert torch.equal(ours, stepped)


def _writers(root):
    """Every synthetic writer's district and the golden one."""
    yield "battery_pv", write_battery_pv_dataset(f"{root}/a", 3, 200)
    yield "thermal", write_thermal_dataset(f"{root}/b", 4, 200)
    yield "thermal_heating", write_thermal_dataset(f"{root}/c", 4, 200, heating=True)
    yield "ev", write_ev_dataset(f"{root}/d", 4, 3, 4, 1, 200)
    yield "lstm", write_lstm_dataset(f"{root}/e", n_rows=200)
    yield "lstm_heterogeneous_outage", write_lstm_dataset(f"{root}/f", n_rows=200,
                                                          heterogeneous=True, outage=True)
    yield "neighborhood", write_neighborhood_dataset(f"{root}/g", 6, 200)
    yield "neighborhood_quebec", write_neighborhood_dataset(f"{root}/h", 6, 200, quebec=True)
    yield "quebec_occ", GOLDEN


def test_dispatch_matches_jax(tmp_path):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core import evaluate_fast as jax_evaluate_fast
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast
    from citylearn_tpu.core.params import pack as jax_pack

    families = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, path in _writers(str(tmp_path)):
            kw = dict(episode_time_steps=48)
            cfg, params, _ = pack(compile_schema(path, **kw), device="cpu")
            jcfg, jparams, _ = jax_pack(jax_compile(path, **kw))
            assert rollout_fast.eligible_neighborhood(cfg) \
                == jax_rollout_fast.eligible_neighborhood(jcfg), name
            assert rollout_fast.neighborhood_packable(cfg, params) \
                == jax_rollout_fast.neighborhood_packable(jcfg, jparams), name
            families[name] = evaluate_fast.kernel_family(cfg)
            assert families[name] == jax_evaluate_fast.kernel_family(jcfg), name
    assert families["neighborhood"] == families["neighborhood_quebec"] \
        == families["quebec_occ"] == "neighborhood"
    assert families["lstm"] == "lstm" and families["battery_pv"] == "battery"


def test_neighborhood_packable_rules(districts):
    """The data-level rules: more than 128 buildings, a tank that is not
    inert, a second lookback or a district the LSTM kernel serves are not
    this kernel's."""
    _, (cfg, params) = districts["eulp"]
    assert rollout_fast.neighborhood_packable(cfg, params)
    tank = dataclasses.replace(params.heating_storage,
                               capacity=params.heating_storage.capacity + 1.0)
    assert not rollout_fast.neighborhood_packable(
        cfg, dataclasses.replace(params, heating_storage=tank))
    groups = ((24,) + cfg.dyn_groups[0][1:],) + cfg.dyn_groups[1:]
    assert not rollout_fast.neighborhood_packable(dataclasses.replace(cfg, dyn_groups=groups),
                                                  params)
    assert not rollout_fast.neighborhood_packable(dataclasses.replace(cfg, n_buildings=129),
                                                  params)
    assert not rollout_fast.eligible_neighborhood(dataclasses.replace(cfg, reward_exponent=2.0))


def _digest(root, skip=(".pth",)):
    h = hashlib.sha256()
    for name in sorted(os.listdir(root)):
        if not name.endswith(skip):
            with open(os.path.join(root, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


#: the files the four earlier writers wrote before the neighborhood writer
#: and the minutes flag existed (the LSTM weights' .pth files aside, whose
#: bytes follow the installed torch's serializer)
EARLIER = {
    "battery_pv": (write_battery_pv_dataset, (5, 200), {},
                   "221f35af38d31fe93c3216ef69f5e50eb6713ba232f8ce5e3617269ecd9c81c3"),
    "thermal": (write_thermal_dataset, (9, 200), {},
                "51f48d99f229a8057b0f35f83beecc33311e84f39527428ab64948bc85664819"),
    "thermal_heating": (write_thermal_dataset, (9, 200), {"heating": True},
                        "f805bd09af5e8ff3bfaf2b967d782e678428d59642bab2fb2469841628317622"),
    "ev": (write_ev_dataset, (6, 4, 7, 1, 200), {},
           "f3d9e21e35fddcd9e4ce3f4142100326266d49b68761f0c019fb9f381a4b08f2"),
    "ev_constraints": (write_ev_dataset, (6, 4, 7, 1, 200), {"constraints": True},
                       "e5a4346f884b15d9228da97a57a520f3f141b6b702808626e4b538146c4a572b"),
    "lstm": (write_lstm_dataset, (), {"n_rows": 200},
             "7b40716eaa3b462c7ce177d870b96cc62380b22c2966cfe59fd234a87f050742"),
    "lstm_heterogeneous_outage": (
        write_lstm_dataset, (), {"n_rows": 200, "heterogeneous": True, "outage": True},
        "95549caf4d0c558d33447cc4dbba2789d4892a5190a426a5834a977b5c61ac29"),
}


@pytest.mark.parametrize("name", list(EARLIER))
def test_earlier_writers_write_the_same_files(tmp_path, name):
    writer, args, kw, digest = EARLIER[name]
    writer(str(tmp_path), *args, seed=3, **kw)
    assert _digest(str(tmp_path)) == digest


def test_neighborhood_writer_guarantees(tmp_path):
    """What the neighborhood tests rely on: the EULP shape's modes, LSTM
    shapes and channels, devices and reward; the quebec shape's occupants,
    missing trees and null battery; determinism."""
    a, b, c, d = (str(tmp_path / x) for x in "abcd")
    write_neighborhood_dataset(a, 3, 100, seed=4)
    write_neighborhood_dataset(b, 3, 100, seed=4)
    write_neighborhood_dataset(c, 3, 100, seed=5)
    assert _digest(a, ()) == _digest(b, ()) != _digest(c, ())
    spec = compile_schema(write_neighborhood_dataset(d, 12, 8760, seed=4))
    cfg, params, _ = pack(spec, device="cpu")
    assert cfg.reward_type == "RewardFunction" and not cfg.has_occupant
    assert {g[2] for g in cfg.dyn_groups} == {8, 16, 24, 32}
    assert {g[1] for g in cfg.dyn_groups} == {1, 2} and {g[0] for g in cfg.dyn_groups} == {12}
    channels = {(g[5] >= 0, g[6] >= 0) for g in cfg.dyn_groups}
    assert channels == {(True, False), (False, True), (True, True)}
    assert sum(g[3] for g in cfg.dyn_groups) > 128
    assert set(params.series.hvac_mode[:, 0].tolist()) == {0, 1, 2, 3}
    assert all(b.active_actions == ["electrical_storage", "cooling_or_heating_device"]
               for b in spec.buildings)
    assert float(params.cooling_storage.capacity.max()) == 0.0
    assert float(params.dhw_storage.capacity.min()) > 0.0
    assert not bool(params.heating_device.is_heat_pump.all())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        qcfg, qparams, _ = pack(compile_schema(write_neighborhood_dataset(
            str(tmp_path / "e"), 20, 100, quebec=True)), device="cpu")
    assert len(caught) == 2 * 20 and qcfg.n_buildings == 20
    assert qcfg.has_occupant and qcfg.reward_type == "ComfortReward" and qcfg.central_agent
    assert float(qparams.battery.capacity.abs().max()) == 0.0
    assert all(g[5] < 0 <= g[6] for g in qcfg.dyn_groups)


def test_wrapper_rejections(districts):
    _, (cfg, params) = districts["eulp"]
    inputs = rollout_fast.neighborhood_episode_inputs(cfg, params, 2, PLANS, n_steps=24)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k6.neighborhood_episode(**{k: v.to("meta") if torch.is_tensor(v) else
                                   tuple(x.to("meta") for x in v) if isinstance(v, tuple)
                                   else v for k, v in inputs.items()})
    with pytest.raises(ValueError, match="4 plans, 9 series"):
        k6.neighborhood_episode(**dict(inputs, series=inputs["series"][:8]))
    with pytest.raises(ValueError, match="not eligible"):
        rollout_fast.run_neighborhood_episode(dataclasses.replace(cfg, reward_exponent=2.0),
                                              params, 1, PLANS, device="cpu")


def test_operation_count(districts):
    """Each district adds its battery event, sums and tank decay; the
    prelude's work appears once, whatever the count of districts."""
    from citylearn_tpu_torch.ops import battery as k1

    _, (cfg, params) = districts["eulp"]
    inputs = rollout_fast.neighborhood_episode_inputs(cfg, params, 4, PLANS, n_steps=24)
    n_knots = inputs["curves"][0].shape[0]
    count = lambda d: k6.operation_count(inputs["actions"], n_knots, d)
    a_bat = inputs["actions"][3]
    per_district = k1.operation_count(a_bat, n_knots, 1) + 5 * a_bat.numel()
    assert count(7) - count(1) == 6 * per_district
    shared = count(1) - per_district
    assert shared == 70 * 24 * cfg.n_buildings
    assert 60 < per_district / (24 * cfg.n_buildings) < 90


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_districts", [("eulp", D), ("quebec", D), ("quebec", 301)],
                         ids=["eulp", "quebec", "quebec-301"])
def test_cuda_kernel_matches_reference(districts, name, n_districts):
    """K6 on the card against its plain version: every output and row
    bit-equal; at D=301, no multiple of a block's districts, on the quebec
    district's null battery too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    _, (cfg, params) = districts[name]
    inputs = seeded_inputs(cfg, params, seed=1, n_districts=n_districts)
    dev = {k: (v.cuda() if torch.is_tensor(v) else tuple(x.cuda() for x in v)
               if isinstance(v, tuple) else v) for k, v in inputs.items()}
    before = k6.neighborhood_episode.launches
    ours = k6.neighborhood_episode(**dev, record=True)
    torch.cuda.synchronize()
    assert k6.neighborhood_episode.launches == before + 1
    ref = k6.neighborhood_episode_reference(**dev, record=True)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
