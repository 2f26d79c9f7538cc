"""The neighborhood family's evaluation path on the CPU against the JAX
package's: the temperature and set-point post-pass
(``core.neighborhood_eval.temp_setpoint_series``, here its plain version,
the step loop over ``dynamics_update`` and ``occupant_update``) on the
demand observations K6 recorded; the kernel-backed ``evaluate_scripted``
KPI table (K6's plain version, the post-pass, the assembly with the final
occupant state) against JAX's, run with its Pallas kernel in interpret
mode, and against the port's own stepped ``evaluate_districts``; a shifted
episode window; the ``evaluate_districts`` dispatch. Fixtures:
``tests/golden/quebec_occ`` (real decision trees) and both shapes of
``citylearn_tpu_torch.synthetic.write_neighborhood_dataset`` (the EULP shape
at 6 buildings in 6 LSTM groups, the quebec shape at 3 in 2).

Tolerances: temperature 2e-4 |T| + 5e-3 (the LSTM's sums run in another
order than XLA's, as for K5); set points exactly equal (data plus tree
deltas, decided by the temperature, and no step of these runs lies within
its tolerance of a decision); KPI tables 1e-5 relative to max(|value|, 1),
the KPIs that count or average steps beyond a comfort threshold within 2
steps in 168, as for the LSTM family."""

import os
import warnings

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.neighborhood_eval import temp_setpoint_series
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.ops import neighborhood as k6
from citylearn_tpu_torch.ops import postpass as p6
from citylearn_tpu_torch.synthetic import write_neighborhood_dataset

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "quebec_occ", "schema.json")
S = 168
WEEK = 2952              # late May: hvac_mode goes from 3 to 1
BASE = "_without_storage_and_partial_load"
HRS = np.arange(1, 25)
PLANS = {"cooling_or_heating_device": np.where(HRS < 12, 0.6, -0.5).astype(np.float32),
         "heating_device": np.where(HRS < 8, 0.3, 0.1).astype(np.float32),
         "electrical_storage": np.where(HRS < 9, 0.091, -0.08).astype(np.float32)}
COMFORT = ("discomfort", "one_minus_thermal_resilience")


@pytest.fixture(scope="module")
def districts(tmp_path_factory):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.params import pack as jax_pack

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the quebec shape's missing trees
        for name, path, kw in (
                ("golden", GOLDEN, {}),
                ("eulp", write_neighborhood_dataset(str(tmp_path_factory.mktemp("eulp")), 6,
                                                    8760, seed=6),
                 {"simulation_start_time_step": WEEK}),
                ("quebec", write_neighborhood_dataset(str(tmp_path_factory.mktemp("quebec")),
                                                      3, 400, seed=6, quebec=True), {})):
            kw = dict(kw, episode_time_steps=S + 1)
            out[name] = (pack(compile_schema(path, **kw), device="cpu")[:2],
                         jax_pack(jax_compile(path, **kw))[:2])
    return out


def recorded_obs(cfg, params, n_steps=S, data_offset=0):
    rec = rollout_fast.run_neighborhood_episode(cfg, params, 1, PLANS, n_steps=n_steps,
                                                record_series=True, data_offset=data_offset,
                                                device="cpu")[-1]
    return rec[k6.R_COUT], rec[k6.R_HOUT]


def assert_temperature_close(ours, ref):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    assert (np.abs(ours - ref) <= 2e-4 * np.abs(ref) + 5e-3).all(), np.abs(ours - ref).max()


@pytest.mark.parametrize("name", ["golden", "eulp", "quebec"])
def test_temp_setpoint_series_matches_jax(districts, name):
    from citylearn_tpu.core.neighborhood_eval import temp_setpoint_series as jax_series

    (cfg, params), (jcfg, jparams) = districts[name]
    cool, heat = recorded_obs(cfg, params)
    temp, csp, hsp, final = temp_setpoint_series(cfg, params, cool, heat, S)
    jtemp, jcsp, jhsp, jfinal = jax_series(jcfg, jparams, cool.numpy(), heat.numpy(), S)
    assert_temperature_close(temp, jtemp)
    np.testing.assert_array_equal(csp.numpy(), np.asarray(jcsp))
    np.testing.assert_array_equal(hsp.numpy(), np.asarray(jhsp))
    assert (final is None) == (jfinal is None) == (not cfg.has_occupant)
    if final is not None:
        for k in ("occ_csp_override", "occ_hsp_override", "occ_hold_counter", "occ_prev_csp",
                  "occ_prev_hsp"):
            np.testing.assert_array_equal(getattr(final, k)[0].numpy(),
                                          np.asarray(getattr(jfinal, k)), err_msg=k)
    # predictions leave the data temperature after the warm-up, and only then
    ideal = params.series.indoor_dry_bulb_temperature[:S]
    assert torch.equal(temp[:12], ideal[:12]) and float((temp - ideal).abs().max()) > 0.5
    if name == "golden":
        data = params.series.indoor_dry_bulb_temperature_heating_set_point[:S]
        assert not torch.equal(hsp, data) and torch.equal(hsp[:12], data[:12])


def table_error(ours, ref, comfort_steps=2):
    """Largest error of ``ours`` against ``ref``, relative to max(|value|,
    1), apart from the comfort KPIs, which may move by ``comfort_steps``
    steps in S; NaN where and only where the reference has it."""
    assert set(ours) == set(ref)
    worst = 0.0
    for k in ours:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), k
        finite = ~np.isnan(b)
        err = float((np.abs(a - b)[finite] / np.maximum(np.abs(b[finite]), 1.0)).max(initial=0))
        tol = 1e-5 + (comfort_steps / S if k.split("|")[1].startswith(COMFORT) else 0.0)
        assert err <= tol, (k, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("name", ["golden", "eulp", "quebec"])
def test_kernel_table_matches_jax(districts, name):
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate

    (cfg, params), (jcfg, jparams) = districts[name]
    ours = evaluate_scripted(cfg, params, ScriptedPolicy(PLANS), baseline_condition=BASE,
                             device="cpu")
    ref = jax_evaluate(jcfg, jparams, JaxPolicy(PLANS), baseline_condition=BASE,
                       interpret=True)
    table_error(ours, ref)


@pytest.mark.parametrize("name", ["golden", "eulp"])
def test_kernel_table_matches_stepped(districts, name):
    """The port's kernel-backed table against its own stepped path, where
    the final occupant state patches the unwritten row alike."""
    (cfg, params), _ = districts[name]
    policy = ScriptedPolicy(PLANS)
    fast = evaluate_scripted(cfg, params, policy, baseline_condition=BASE, device="cpu")
    states = batched_initial_states(cfg, params, 1, device="cpu")
    stepped = evaluate_districts(cfg, params, states, policy.as_policy_fn(cfg, params, S),
                                 baseline_condition=BASE, device="cpu")
    table_error(fast, {k: v[0] for k, v in stepped.items()})
    served = evaluate_districts(cfg, params, states, policy, baseline_condition=BASE,
                                device="cpu")
    for k, v in served.items():
        assert torch.equal(v[0].nan_to_num(), fast[k].nan_to_num()), k


def test_shifted_window(districts):
    """An episode window at an offset, as the JAX package's
    ``test_neighborhood_shifted_window``: the tables agree with JAX's and
    the stepped path's, and the post-pass reads the occupant's final row at
    the window's end."""
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate

    (cfg, params), (jcfg, jparams) = districts["golden"]
    n, off = 72, 48
    ours = evaluate_scripted(cfg, params, ScriptedPolicy(PLANS), n_steps=n,
                             baseline_condition=BASE, data_offset=off, device="cpu")
    ref = jax_evaluate(jcfg, jparams, JaxPolicy(PLANS), n_steps=n, baseline_condition=BASE,
                       interpret=True, data_offset=off)
    table_error(ours, ref)
    states = batched_initial_states(cfg, params, 1, off, device="cpu")
    stepped = evaluate_districts(cfg, params, states,
                                 ScriptedPolicy(PLANS).as_policy_fn(cfg, params, n), n,
                                 baseline_condition=BASE, device="cpu")
    table_error(ours, {k: v[0] for k, v in stepped.items()})
    cool, heat = recorded_obs(cfg, params, n, off)
    shifted = p6.neighborhood_postpass(cfg, params, cool, heat, n, off)
    unshifted = p6.neighborhood_postpass(cfg, params, cool, heat, n, 0)
    assert not torch.equal(shifted[0], unshifted[0])
    assert int(shifted[3].data_offset[0]) == off


def test_unpackable_district_takes_the_stepped_path(districts):
    import dataclasses

    (cfg, params), _ = districts["quebec"]
    tank = dataclasses.replace(params.cooling_storage,
                               capacity=params.cooling_storage.capacity + 1.0)
    unpackable = dataclasses.replace(params, cooling_storage=tank)
    assert not rollout_fast.neighborhood_packable(cfg, unpackable)
    with pytest.raises(ValueError, match="neighborhood-packable"):
        evaluate_scripted(cfg, unpackable, ScriptedPolicy(PLANS), n_steps=24, device="cpu")
    states = batched_initial_states(cfg, unpackable, 1, device="cpu")
    before = k6.neighborhood_episode.launches
    table = evaluate_districts(cfg, unpackable, states, ScriptedPolicy(PLANS), 24,
                               device="cpu")
    assert k6.neighborhood_episode.launches == before and len(table) == 37


def test_postpass_wrapper(districts):
    """The wrapper takes CPU tensors to the plain version and refuses any
    other device but CUDA; the operation count follows the LSTMs' shapes."""
    (cfg, params), _ = districts["eulp"]
    cool, heat = recorded_obs(cfg, params, 24)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        p6.neighborhood_postpass(cfg, params, cool.to("meta"), heat.to("meta"), 24)
    inputs = p6.postpass_inputs(cfg, params, cool, heat, 24)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p6.postpass_kernel(**inputs)
    assert inputs["occupant"] is None and inputs["series"][0].shape == (24, 6)
    n = p6.operation_count(inputs["weights"], inputs["lookback"], 24)
    # layer 1 multiplies the dynamic channels per cell, the static ones once
    # per row of the stream that a window reads (rows 1 to 23)
    dyn = [sum(u[k] >= 0 for k in (p6.M_TEMP_CH, p6.M_COOL_CH, p6.M_HEAT_CH))
           for u in inputs["weights"].units]
    cells = sum(12 * (2 * 4 * H * (n + H) + 9 * H
                      + (2 * 4 * H * 2 * H + 9 * H if L == 2 else 0)) + 2 * H + 2
                for (L, H, F, *_), n in zip(inputs["weights"].units, dyn))
    static = sum(23 * 2 * 4 * H * (F - n) for (L, H, F, *_), n in zip(inputs["weights"].units, dyn))
    assert 2 in dyn and 3 in dyn
    assert n == 12 * cells + static + 6 * 24 * 6
