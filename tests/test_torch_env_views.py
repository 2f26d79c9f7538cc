"""The port's building views, numpy KPIs and CSV renderer against the JAX
package's.

- Every ``BuildingView`` series of the port's env against the JAX env's
  after the same random actions, part of the way through an episode and
  at its end: the per-building series, the four counterfactual conditions
  (without storage, and PV, and partial load, and both), the device, tank,
  battery and PV views, the input-data windows, the COP series, and the
  charger views of the EV district; and ``evaluate()`` under every
  ``EvaluationCondition`` as control and as baseline. Tolerance 1e-5 of
  each series' scale, as in ``test_torch_env.py``.
- The ``*_np`` KPI functions of ``core/kpi.py``: the same numpy code as
  the JAX package's, so bit-equal on seeded inputs with NaNs, zeros and
  negative values.
- ``CSVRenderer``: the files it writes, in both modes, byte-equal to the
  JAX renderer's on the same episode. The episodes run in the float64
  parity mode, where both packages' series agree to the bit (in float32
  XLA's fused multiply-adds move last bits, and the CSVs print every
  bit)."""

import filecmp
import os

import numpy as np
import pytest

import _env_parity as ep
from citylearn_tpu import EvaluationCondition as JaxEvaluationCondition
from citylearn_tpu.core import kpi as jax_kpi
from citylearn_tpu_torch import EvaluationCondition
from citylearn_tpu_torch.core import kpi

TOL = 1e-5
FAMILIES = ("battery", "thermal", "ev_constrained", "lstm_outage")

SERIES = (
    "net_electricity_consumption", "net_electricity_consumption_cost",
    "net_electricity_consumption_emission",
    "net_electricity_consumption_without_storage",
    "net_electricity_consumption_without_storage_and_pv",
    "net_electricity_consumption_without_storage_and_partial_load",
    "net_electricity_consumption_without_storage_and_partial_load_and_pv",
    "cooling_electricity_consumption", "heating_electricity_consumption",
    "dhw_electricity_consumption", "non_shiftable_load_electricity_consumption",
    "solar_generation", "cooling_demand", "heating_demand", "dhw_demand",
    "non_shiftable_load", "energy_from_cooling_device", "energy_from_heating_device",
    "energy_from_dhw_device", "cooling_storage_electricity_consumption",
    "heating_storage_electricity_consumption", "dhw_storage_electricity_consumption",
    "electrical_storage_electricity_consumption", "energy_from_cooling_storage",
    "energy_from_heating_storage", "energy_from_dhw_storage",
    "energy_from_electrical_storage", "energy_from_cooling_device_to_cooling_storage",
    "energy_from_heating_device_to_heating_storage",
    "energy_from_dhw_device_to_dhw_storage", "energy_to_electrical_storage",
    "energy_to_non_shiftable_load", "cooling_device_cop", "heating_device_cop",
    "dhw_device_cop", "cooling_demand_without_partial_load",
    "heating_demand_without_partial_load",
    "indoor_dry_bulb_temperature_without_partial_load", "indoor_dry_bulb_temperature",
    "indoor_dry_bulb_temperature_cooling_set_point",
    "indoor_dry_bulb_temperature_heating_set_point", "power_outage_signal",
    "chargers_electricity_consumption",
)
WINDOWS = {"energy_simulation": ("hour", "month", "indoor_dry_bulb_temperature",
                                 "cooling_demand", "heating_demand", "non_shiftable_load",
                                 "indoor_dry_bulb_temperature_cooling_set_point",
                                 "occupant_count", "power_outage"),
           "weather": ("outdoor_dry_bulb_temperature", "direct_solar_irradiance_predicted_1"),
           "pricing": ("electricity_pricing", "electricity_pricing_predicted_2"),
           "carbon_intensity": ("carbon_intensity",)}


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    return ep.write_all(tmp_path_factory)


def assert_views_close(ours, ref):
    temps = np.linspace(-5.0, 35.0, 9)
    for bo, br in zip(ours.buildings, ref.buildings):
        assert repr(bo) == repr(br)
        assert (bo.name, bo.index) == (br.name, br.index)
        for name in SERIES:
            ep.assert_close(getattr(bo, name), getattr(br, name), TOL, f"{bo.name}.{name}")
        for kind in ("cooling_storage", "heating_storage", "dhw_storage", "electrical_storage"):
            vo, vr = getattr(bo, kind), getattr(br, kind)
            assert vo.capacity == vr.capacity
            for name in ("soc", "energy_balance", "electricity_consumption"):
                ep.assert_close(getattr(vo, name), getattr(vr, name), TOL, f"{kind}.{name}")
        ep.assert_close(bo.electrical_storage.degraded_capacity,
                        br.electrical_storage.degraded_capacity, TOL, "degraded_capacity")
        for kind, heating in (("cooling_device", False), ("heating_device", True),
                              ("dhw_device", True)):
            vo, vr = getattr(bo, kind), getattr(br, kind)
            assert (vo.is_heat_pump, vo.nominal_power) == (vr.is_heat_pump, vr.nominal_power)
            ep.assert_close(vo.electricity_consumption, vr.electricity_consumption, TOL, kind)
            np.testing.assert_array_equal(vo.get_cop(temps, heating), vr.get_cop(temps, heating))
            np.testing.assert_array_equal(vo.get_input_power(np.full(9, 2.5), temps, heating),
                                          vr.get_input_power(np.full(9, 2.5), temps, heating))
        assert bo.pv.nominal_power == br.pv.nominal_power
        np.testing.assert_array_equal(bo.pv.get_generation(temps), br.pv.get_generation(temps))
        ep.assert_close(bo.pv.electricity_consumption, br.pv.electricity_consumption, TOL, "pv")
        for view, fields in WINDOWS.items():
            for field in fields:
                ep.assert_close(getattr(getattr(bo, view), field),
                                getattr(getattr(br, view), field), TOL, f"{view}.{field}")
        so, sr = bo.observations(), br.observations()
        assert list(so) == list(sr)
        ep.assert_close(list(so.values()), list(sr.values()), TOL, "observations()")
        assert bo.observation_space == br.observation_space
        assert bo.action_space == br.action_space
        chargers = list(zip(bo.electric_vehicle_chargers, br.electric_vehicle_chargers))
        assert len(chargers) == len(br.electric_vehicle_chargers)
        for co, cr in chargers:
            assert co.charger_id == cr.charger_id
            for name in ("electricity_consumption", "past_charging_action_values_kwh"):
                ep.assert_close(getattr(co, name), getattr(cr, name), TOL, name)


@pytest.mark.parametrize("family", FAMILIES)
def test_building_views_match_jax(schemas, family):
    ours, ref = ep.pair(schemas[family], episode_time_steps=48)
    assert_views_close(ours, ref)                     # at reset
    ep.run_episode(ours, ref, 20, seed=5, tol=TOL)    # part of the way
    assert_views_close(ours, ref)
    rng = np.random.RandomState(6)
    while not ours.terminated:
        acts = ep.random_actions(ref, rng)
        ours.step(acts)
        ref.step(acts)
    assert_views_close(ours, ref)
    if family == "ev_constrained":
        assert sum(len(b.electric_vehicle_chargers) for b in ours.buildings) == 3


def test_evaluate_under_every_condition_matches_jax(schemas):
    """On the LSTM district (whose default baseline is the partial-load
    one): every member of ``EvaluationCondition`` as control and as
    baseline, and a comfort band."""
    ours, ref = ep.pair(schemas["lstm_outage"], episode_time_steps=48)
    ep.run_episode(ours, ref, 47, seed=8, tol=TOL)
    assert [c.name for c in EvaluationCondition] == [c.name for c in JaxEvaluationCondition]
    for c in EvaluationCondition:
        jc = JaxEvaluationCondition[c.name]
        assert c.value == jc.value
        ep.assert_frames_close(ours.evaluate(control_condition=c),
                               ref.evaluate(control_condition=jc), TOL)
        ep.assert_frames_close(ours.evaluate(baseline_condition=c, comfort_band=2.0),
                               ref.evaluate(baseline_condition=jc, comfort_band=2.0), TOL)
    for name in ("net_electricity_consumption_without_storage_and_partial_load",
                 "net_electricity_consumption_without_storage_and_partial_load_and_pv"):
        ep.assert_close(getattr(ours, name), getattr(ref, name), TOL, name)


def _kpi_inputs(seed, n):
    rng = np.random.RandomState(seed)
    net = rng.normal(0.5, 2.0, n).astype(np.float32)
    net[rng.rand(n) < 0.05] = np.nan
    t = rng.uniform(15.0, 32.0, n).astype(np.float32)
    csp = np.full(n, 25.0, np.float32)
    hsp = np.full(n, 20.0, np.float32)
    band = np.full(n, 2.0, np.float32)
    occ = (rng.rand(n) < 0.7).astype(np.float32) * 3
    outage = (rng.rand(n) < 0.2).astype(np.float32)
    expected = rng.uniform(0.0, 5.0, n)
    served = expected * rng.uniform(0.5, 1.0, n)
    return net, t, csp, hsp, band, occ, outage, expected, served


@pytest.mark.parametrize("n", [1, 23, 169, 800])
def test_np_kpis_are_bit_equal(n):
    net, t, csp, hsp, band, occ, outage, expected, served = _kpi_inputs(n, n)
    calls = {
        "ramping_np": lambda m: (m.ramping_np(net), m.ramping_np(net, down_ramp=True),
                                 m.ramping_np(net, net_export=False)),
        "one_minus_load_factor_np": lambda m: (m.one_minus_load_factor_np(net, 24),
                                               m.one_minus_load_factor_np(net, 730)),
        "peak_np": lambda m: (m.peak_np(np.nan_to_num(net), 24),
                              m.peak_np(np.nan_to_num(net), n)),
        "electricity_consumption_np": lambda m: m.electricity_consumption_np(net),
        "zero_net_energy_np": lambda m: m.zero_net_energy_np(net),
        "carbon_emissions_np": lambda m: m.carbon_emissions_np(net * 0.4),
        "cost_np": lambda m: m.cost_np(net * 0.2),
        "quadratic_np": lambda m: m.quadratic_np(net),
        "discomfort_np": lambda m: (m.discomfort_np(t, csp, hsp, band, occ),
                                    m.discomfort_np(t, csp, hsp, band)),
        "one_minus_thermal_resilience_np": lambda m: m.one_minus_thermal_resilience_np(
            outage, indoor_t=t, cooling_set_point=csp, heating_set_point=hsp, band=band,
            occupant_count=occ),
        "normalized_unserved_energy_np": lambda m: (
            m.normalized_unserved_energy_np(expected, served, outage),
            m.normalized_unserved_energy_np(expected, served),
            m.normalized_unserved_energy_np(expected, served, np.zeros(n))),
        "safe_div": lambda m: (m.safe_div(3.0, 2.0), m.safe_div(0.0, 0.0), m.safe_div(1.0, 0.0),
                               m.safe_div(np.nan, 2.0), m.safe_div(np.inf, 1.0)),
    }
    for name, call in calls.items():
        with np.errstate(all="ignore"):
            assert_bit_equal(call(kpi), call(jax_kpi), name)


def assert_bit_equal(ours, ref, name):
    """The same value to the bit (NaN as NaN, None as None), recursively
    over tuples."""
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref), name
        for a, b in zip(ours, ref):
            assert_bit_equal(a, b, name)
    elif ref is None:
        assert ours is None, name
    else:
        assert type(ours) is type(ref), name
        assert np.float64(ours).tobytes() == np.float64(ref).tobytes(), (name, ours, ref)


def _render_pair(path, tmp_path, mode, **kw):
    dirs = (str(tmp_path / "ours"), str(tmp_path / "ref"))
    envs = ep.pair(path, render=True, render_mode=mode, render_session_name="session",
                   start_date="2021-06-01T00:00:00", parity_f64=True, **kw)
    for env, d in zip(envs, dirs):
        env._renderer.directory = os.path.join(d, "session")
    return envs, [os.path.join(d, "session") for d in dirs]


@pytest.mark.parametrize("family,mode", [("battery", "during"), ("ev_constrained", "end")])
def test_csv_renderer_files_are_byte_equal(schemas, tmp_path, family, mode):
    (ours, ref), (d_ours, d_ref) = _render_pair(schemas[family], tmp_path, mode,
                                                episode_time_steps=48)
    ep.run_episode(ours, ref, 47, seed=9, tol=0.0)
    ours.export_final_kpis(filepath="kpis_again.csv")
    ref.export_final_kpis(filepath="kpis_again.csv")
    files = sorted(os.listdir(d_ref))
    assert files == sorted(os.listdir(d_ours))
    assert "exported_kpis.csv" in files and "kpis_again.csv" in files
    assert len(files) > 2 + 2 * len(ref.buildings)
    match, mismatch, errors = filecmp.cmpfiles(d_ours, d_ref, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
