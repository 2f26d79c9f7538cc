"""Kernel K5, the whole-episode LSTM-dynamics rollout, and the fast path
around it: the port's plain version against the JAX package's Pallas
kernel run in interpret mode (reached through the JAX package's
``run_lstm_episode``, which does its TPU packing); ``run_lstm_episode`` at
a shifted window and ``evaluate_scripted`` against the JAX package's; the
kernel-backed KPI table against the stepped one, with the partial-load
baseline; ``lstm_packable`` against the JAX package's; the dispatch of
``evaluate_districts`` and its fall-back to the stepped path; the
wrapper's rejections; the operation count; and, on a CUDA card, the
hand-written kernel against its plain version.

Tolerances. Against JAX, physics outputs and rows: 1e-5 relative to each
output's scale (XLA:CPU contracts ``a + b * c``; the Pallas kernel scatters
channels through matrix products). Temperature, last temperature, the
reward row and the reward sum: 2e-4 relative plus 5e-3 absolute, the JAX
package's own tolerance between its kernel and its scan
(``tests/test_pallas_lstm.py``); KPI tables 1e-5 relative with a floor of
1e-6, except the discomfort proportions, which count steps across a
threshold and are held to one step in S. The lookback is 4 here to keep
the interpreter quick. On the card: the physics is built with
``-fmad=false`` and IEEE division and square root and is expected
bit-equal (held to 1e-6 of scale, 1e-5 on the sums); temperature is held
to 2e-4 relative plus 5e-3, the reward row to the same on all but 1 step
in 1000 (a temperature within the LSTM's error of a threshold lands on its
other side), the reward sum to 1e-3 of its scale.

The card's machine has no JAX: the JAX side is imported inside the tests
that compare with it, and the ``gpu`` tests run there with
``python -m pytest --noconftest -m gpu tests/test_torch_kernel_lstm.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import evaluate_fast, rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.ops import lstm as k5
from citylearn_tpu_torch.synthetic import write_lstm_dataset

S = 120
HOURS = np.arange(1, 25)
PLANS = {"cooling_device": np.where(HOURS < 12, 0.8, 0.4).astype(np.float32),
         "cooling_storage": np.where(HOURS < 7, 0.05, -0.03).astype(np.float32),
         "dhw_storage": np.full(24, 0.05, np.float32),
         "electrical_storage": np.where(HOURS < 9, 0.091, -0.08).astype(np.float32)}
OUTPUTS = ("reward", "cost", "emission", "cooling_soc", "dhw_soc", "soc", "eff", "deg",
           "last_temp", "record")
LSTM_ROWS = (k5.R_TEMP, k5.R_REWARD)
DATASETS = {"default": dict(), "heterogeneous_outage": dict(heterogeneous=True, outage=True)}


def assert_close(ours, ref, name, rtol=1e-5, atol=0.0, allow=0.0):
    ours = ours.cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = ref.cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert ours.shape == ref.shape, name
    scale = float(np.max(np.abs(ref), initial=0.0)) or 1.0
    bad = np.abs(ours - ref) > rtol * np.abs(ref) + rtol * scale + atol
    assert bad.mean() <= allow, (name, int(bad.sum()), float(np.abs(ours - ref).max()))


def assert_outputs_close(ours, ref, d=slice(None)):
    """The 9 outputs and 13 rows of K5 against a reference's."""
    for name, a, b in zip(OUTPUTS[:9], ours, ref):
        lstm = name in ("reward", "last_temp")
        assert_close(a, np.asarray(b)[d], name, *((2e-4, 5e-3) if lstm else (1e-5,)))
    rec, ref_rec = ours[9], np.asarray(ref[9])
    assert rec.shape == ref_rec.shape and rec.shape[0] == k5.N_LREC
    for row in range(k5.N_LREC):
        assert_close(rec[row], ref_rec[row], f"row {row}",
                     *((2e-4, 5e-3) if row in LSTM_ROWS else (1e-5,)))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """name -> schema path: lookback 4, S + 41 rows."""
    return {name: write_lstm_dataset(str(tmp_path_factory.mktemp(name)), n_rows=S + 41, seed=9,
                                     lookback=4, **kw) for name, kw in DATASETS.items()}


@pytest.fixture(scope="module")
def port_districts(datasets):
    """name -> (cfg, params) of the port."""
    return {name: pack(compile_schema(path, episode_time_steps=S + 1), device="cpu")[:2]
            for name, path in datasets.items()}


@pytest.fixture(scope="module")
def districts(datasets, port_districts):
    """name -> ((cfg, params), (jcfg, jparams))."""
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack

    return {name: (port_districts[name],
                   jax_pack(jax_compile(path, episode_time_steps=S + 1))[:2])
            for name, path in datasets.items()}


@pytest.mark.parametrize("name", list(DATASETS))
def test_reference_matches_jax_interpret(districts, name):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = districts[name]
    assert rollout_fast.lstm_packable(cfg, params)
    ours = rollout_fast.run_lstm_episode(cfg, params, 2, PLANS, record_series=True,
                                         device="cpu")
    ref = jax_rollout_fast.run_lstm_episode(jcfg, jparams, 256, PLANS, interpret=True,
                                            record_series=True)
    assert ours[0].shape == (2, cfg.n_buildings) and ours[9].shape[1:] == (S, cfg.n_buildings)
    assert_outputs_close(ours, ref, slice(0, 2))
    rec = ours[9]
    ideal = params.series.indoor_dry_bulb_temperature[:S]
    assert float((rec[k5.R_TEMP] - ideal)[:4].abs().max()) == 0.0
    assert float((rec[k5.R_TEMP] - ideal)[4:].abs().max()) > 0.5
    assert not torch.equal(rec[k5.R_CDEM][5:], params.series.cooling_demand[5:S])
    assert (rec[k5.R_BBAL] > 0).any() and (rec[k5.R_BBAL] < 0).any()
    assert torch.isfinite(rec).all()
    if cfg.any_outage:
        out = params.series.power_outage[:S] > 0
        assert out.any() and float(rec[k5.R_NET][out].abs().max()) == 0.0
        assert (rec[k5.R_NSLMET][out] < params.series.non_shiftable_load[:S][out] - 1e-6).any()
        assert (rec[k5.R_CBAL][:, 1] > 0).any() and (rec[k5.R_CBAL][:, 1] < 0).any()


def test_run_lstm_episode_matches_jax_at_a_shifted_window(districts):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = districts["heterogeneous_outage"]
    plans = dict(PLANS, cooling_device=np.linspace(0.1, 1.0, S).astype(np.float32))
    ours = rollout_fast.run_lstm_episode(cfg, params, 1, plans, n_steps=S - 20,
                                         record_series=True, data_offset=30, device="cpu")
    ref = jax_rollout_fast.run_lstm_episode(jcfg, jparams, 256, plans, n_steps=S - 20,
                                            interpret=True, record_series=True,
                                            data_offset=30)
    # The JAX dispatcher windows the comfort band twice (it cuts rows
    # [off, off + S) and its stream helper cuts [off:] again), so its
    # kernel reads a band of 0 on the window's last `off` steps. The port
    # reads the band of the window, as both stepped paths do: the reward is
    # compared on the steps before, where the two agree.
    n, off = S - 20, 30
    keep = n - off
    ours = ours[1:9] + (ours[9][:, :keep],)
    ref = tuple(ref[1:9]) + (np.asarray(ref[9])[:, :keep],)
    for name, a, b in zip(OUTPUTS[1:9], ours, ref):
        assert_close(a, np.asarray(b)[:1], name, *((2e-4, 5e-3) if name == "last_temp"
                                                   else (1e-5,)))
    for row in range(k5.N_LREC):
        assert_close(ours[8][row], ref[8][row], f"row {row}",
                     *((2e-4, 5e-3) if row in LSTM_ROWS else (1e-5,)))


@pytest.mark.parametrize("baseline", ["_without_storage", "_without_storage_and_partial_load",
                                      "_without_storage_and_partial_load_and_pv"])
def test_evaluate_scripted_matches_jax(districts, baseline):
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate_scripted

    (cfg, params), (jcfg, jparams) = districts["heterogeneous_outage"]
    assert evaluate_fast.kernel_family(cfg) == "lstm"
    ours, rec = evaluate_scripted(cfg, params, ScriptedPolicy(PLANS),
                                  baseline_condition=baseline, return_series=True,
                                  device="cpu")
    ref, jrec = jax_evaluate_scripted(jcfg, jparams, JaxScriptedPolicy(PLANS),
                                      baseline_condition=baseline, interpret=True,
                                      return_series=True)
    assert rec.shape == np.asarray(jrec).shape
    assert set(ours) == set(ref) and len(ours) == 37
    for k in sorted(ours):
        step = 1.0 / S + 1e-6 if "proportion" in k else 0.0
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6 + step, equal_nan=True, err_msg=k)
    # occupants and outages are present: no KPI is NaN on this district
    assert all(torch.isfinite(v).all() for v in ours.values())
    assert float(ours["district|power_outage_normalized_unserved_energy_total"]) > 0.0


@pytest.mark.parametrize("central", [False, True], ids=["decentral", "central"])
def test_kernel_table_matches_stepped(tmp_path, central):
    """The KPI table assembled from K5's recorded rows equals the one the
    stepped ``district_step`` path collects, for the plain and the
    partial-load baseline, which differ on this district."""
    path = write_lstm_dataset(str(tmp_path), n_rows=S + 1, seed=10, lookback=4, outage=True)
    cfg, params, _ = pack(compile_schema(path, central_agent=central), device="cpu")
    policy = ScriptedPolicy(PLANS)
    states = batched_initial_states(cfg, params, 2, device="cpu")
    tables = {}
    for baseline in ("_without_storage", "_without_storage_and_partial_load"):
        fast = tables[baseline] = evaluate_scripted(cfg, params, policy,
                                                    baseline_condition=baseline, device="cpu")
        stepped = evaluate_districts(cfg, params, states, policy.as_policy_fn(cfg, params, S),
                                     baseline_condition=baseline, device="cpu")
        assert set(fast) == set(stepped) and len(fast) == 37
        for k in fast:
            step = 1.0 / S + 1e-6 if "proportion" in k else 0.0
            np.testing.assert_allclose(fast[k].numpy(), stepped[k][0].numpy(), rtol=1e-5,
                                       atol=1e-6 + step, equal_nan=True, err_msg=k)
    plain, partial = (tables[b]["district|electricity_consumption_total"] for b in tables)
    assert abs(float(plain) - float(partial)) > 1e-3


def test_packable_follows_jax_and_dispatch_falls_back(districts, monkeypatch):
    from citylearn_tpu.core import rollout_fast as jax_rollout_fast

    (cfg, params), (jcfg, jparams) = districts["default"]
    assert rollout_fast.lstm_packable(cfg, params) \
        == jax_rollout_fast.lstm_packable(jcfg, jparams) is True
    assert not rollout_fast.eligible(cfg) and not rollout_fast.eligible_thermal(cfg) \
        and not rollout_fast.eligible_ev(cfg)
    # a heating-side device action makes the district unpackable in both
    on = np.array([True, False, False])
    dyn = dataclasses.replace(params.dynamics[0], heating_device_active=torch.tensor(on))
    unpackable = dataclasses.replace(params, dynamics=(dyn,))
    junpackable = jparams.replace(dynamics=(jparams.dynamics[0].replace(
        heating_device_active=np.asarray(on)),))
    assert rollout_fast.lstm_packable(cfg, unpackable) \
        == jax_rollout_fast.lstm_packable(jcfg, junpackable) is False
    other = dataclasses.replace(cfg, reward_type="RewardFunction")
    jother = dataclasses.replace(jcfg, reward_type="RewardFunction")
    assert rollout_fast.eligible_lstm(other) == jax_rollout_fast.eligible_lstm(jother) is False
    with pytest.raises(ValueError, match="not eligible"):
        rollout_fast.run_lstm_episode(cfg, unpackable, 1, PLANS, device="cpu")
    with pytest.raises(ValueError, match="not kernel-packable"):
        evaluate_scripted(cfg, unpackable, ScriptedPolicy(PLANS), device="cpu")

    calls = []
    real = evaluate_fast.evaluate_scripted
    monkeypatch.setattr(evaluate_fast, "evaluate_scripted",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    policy = ScriptedPolicy(PLANS)
    states = batched_initial_states(cfg, params, 3, device="cpu")
    before = k5.lstm_episode.launches
    fast = evaluate_districts(cfg, params, states, policy, device="cpu")
    assert calls == [1] and k5.lstm_episode.launches == before   # CPU tensors: no launch
    assert fast["building|cost_total"].shape == (3, cfg.n_buildings)
    # the unpackable district is served by the stepped path: the same table
    stepped = evaluate_districts(cfg, unpackable, states, policy, device="cpu")
    assert calls == [1]
    for k in fast:
        step = 1.0 / S + 1e-6 if "proportion" in k else 0.0
        np.testing.assert_allclose(stepped[k].numpy(), fast[k].numpy(), rtol=1e-5,
                                   atol=1e-6 + step, equal_nan=True, err_msg=k)


def test_trainer_refuses_the_family(tmp_path):
    """The trainer takes the family since it routes ``cooling_device``
    (the per-step collect: K2 serves battery+PV only) and still refuses a
    central agent on it, as the JAX trainer does."""
    from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

    path = write_lstm_dataset(str(tmp_path), n_rows=49)
    cfg = TrainConfig(n_districts=2, hidden=(8, 8))
    with pytest.raises(ValueError, match="decentralized"):
        BatchedSAC(path, cfg, device="cpu", central_agent=True)
    trainer = BatchedSAC(path, cfg, device="cpu")
    assert trainer.env_cfg.has_dynamics and not trainer.use_kernel_collect


def kernel_inputs(port_districts, name, D, seed=0):
    """K5's inputs for a district with per-district seeded states and the
    DHW action converted by the DHW tank's own capacity, so that both
    orders of the DHW block run (the heating tank's is 0 here)."""
    cfg, params = port_districts[name]
    plans = dict(PLANS, dhw_storage=np.where(HOURS < 7, 0.05, -0.04).astype(np.float32))
    inputs = rollout_fast.lstm_episode_inputs(cfg, params, D, plans)
    g = torch.Generator().manual_seed(seed)
    rand = lambda lo, hi: lo + (hi - lo) * torch.rand((D, cfg.n_buildings), generator=g)
    inputs.update(csoc0=rand(0, 1), dsoc0=rand(0, 1), soc0=rand(0, 1), eff0=rand(0.85, 0.95),
                  deg0=(inputs["bparams"][0] * rand(0.9, 1.0)).contiguous())
    inputs["tparams"] = inputs["tparams"].clone()
    inputs["tparams"][k5.DT_CONV] = inputs["tparams"][k5.DT_CAP]
    return inputs


def to_device(inputs, device):
    move = lambda v: (v.to(device) if torch.is_tensor(v) else
                      k5.LstmWeights(v.flat.to(device), v.meta.to(device), v.units)
                      if isinstance(v, k5.LstmWeights) else
                      tuple(x.to(device) for x in v) if isinstance(v, tuple) else v)
    return {k: move(v) for k, v in inputs.items()}


def test_weights_round_trip_and_operation_count(port_districts):
    cfg, params = port_districts["heterogeneous_outage"]
    inputs = kernel_inputs(port_districts, "heterogeneous_outage", 2)
    weights = inputs["weights"]
    assert [u[:5] for u in weights.units] == [(2, 8, 12, 11, 4)] * 3 + [(1, 50, 12, 11, 4)]
    assert weights.meta.tolist() == [list(u) for u in weights.units]
    assert k5.static_width(weights) == 48 and inputs["series"][12].shape == (S, 48)
    assert weights.flat.numel() % 4 == 0 and all(u[k5.M_W_OFF] % 4 == 0 for u in weights.units)
    # unpacked, the groups hold the packed district's weights again
    for (members, dyn), packed in zip(k5._groups(weights), params.dynamics):
        assert members == packed.member_indices.tolist()
        for l in range(len(packed.w_ih)):
            assert torch.equal(dyn.w_ih[l], packed.w_ih[l])
            assert torch.equal(dyn.w_hh[l], packed.w_hh[l])
            assert torch.equal(dyn.bias[l], packed.bias[l])
        assert torch.equal(dyn.lin_w, packed.lin_w)
    # both dynamic channels of the static stream are zero, the others data
    chan = inputs["series"][12]
    assert float(chan[:, [4, 11, 16, 23]].abs().max()) == 0.0 and float(chan[:, 0].max()) > 0
    n_knots = inputs["curves"][0].shape[0]
    count = lambda acts, D: k5.operation_count(acts, weights, n_knots, 4, D)
    # layer 1 multiplies its two dynamic channels per cell and its 10 static
    # ones once per building and row of the stream that a window reads
    # (rows 1 to S - 1), for all districts at once
    cell8 = 2 * 32 * 10 + 2 * 32 * 16 + 2 * 9 * 8
    cell50 = 2 * 200 * 52 + 9 * 50
    lstm = (S - 4) * (3 * (4 * cell8 + 18) + 4 * cell50 + 102)
    static = (S - 1) * (3 * 2 * 32 * 10 + 2 * 200 * 10)
    idle = [torch.zeros_like(a) for a in inputs["actions"]]
    assert count(idle, 1) - lstm - static == k5._battery.operation_count(idle[3], n_knots, 1) \
        + idle[3].numel() * 135
    assert count(idle, 7) - 7 * count(idle, 1) == -6 * static
    discharging = [idle[0], idle[1] - 1.0, idle[2] - 1.0, idle[3]]
    assert count(discharging, 1) - count(idle, 1) == 2 * 2 * idle[3].numel()


def test_wrapper_rejections(port_districts):
    inputs = kernel_inputs(port_districts, "default", 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k5.lstm_episode(**to_device(inputs, "meta"))
    with pytest.raises(ValueError, match="lookback"):
        k5.lstm_episode(**dict(inputs, lookback=k5.MAX_LOOKBACK + 1))
    with pytest.raises(ValueError, match="4 plans, 14 series"):
        k5.lstm_episode(**dict(inputs, series=inputs["series"][:13]))
    w = inputs["weights"]
    with pytest.raises(ValueError, match="weights of 2 buildings"):
        k5.lstm_episode(**dict(inputs, weights=k5.LstmWeights(w.flat, w.meta[:2], w.units[:2])))
    wide = ((2, k5.MAX_HIDDEN + 4, 12, 11, 4, 0, 0),) + w.units[1:]
    with pytest.raises(ValueError, match="up to 64 units"):
        k5.lstm_episode(**dict(inputs, weights=k5.LstmWeights(w.flat, w.meta, wide)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DATASETS))
def test_cuda_kernel_matches_reference(port_districts, name):
    """K5 on the card against its plain version: 8 hidden units in two
    layers (the unrolled path), and with a 50-unit single-layer building
    and power outages (the general path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    inputs = to_device(kernel_inputs(port_districts, name, 512, seed=1), "cuda")
    before = k5.lstm_episode.launches
    ours = k5.lstm_episode(**inputs, record=True)
    torch.cuda.synchronize()
    assert k5.lstm_episode.launches == before + 1
    ref = k5.lstm_episode_reference(**inputs, record=True)
    for out, a, b in zip(OUTPUTS[:9], ours, ref):
        if out == "reward":
            assert_close(a, b, out, 1e-3)
        elif out == "last_temp":
            assert_close(a, b, out, 2e-4, 5e-3)
        else:
            assert_close(a, b, out, 1e-5 if out in ("cost", "emission") else 1e-6)
    for row in range(k5.N_LREC):
        if row in LSTM_ROWS:
            assert_close(ours[9][row], ref[9][row], f"row {row}", 2e-4, 5e-3,
                         allow=1e-3 if row == k5.R_REWARD else 0.0)
        else:
            assert_close(ours[9][row], ref[9][row], f"row {row}", 1e-6)
    assert not torch.equal(ours[1][0], ours[1][1])
