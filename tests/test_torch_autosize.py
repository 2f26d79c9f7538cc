"""The port's autosizing in ``compiler/schema.py`` against the JAX
package's: HVAC devices and tanks sized from the district's own demand
series, batteries sampled from a ``battery_choices.yaml``
(``synthetic.write_battery_choices`` under ``CITYLEARN_MISC_ROOT``), PV
(the compiled building: see also ``test_torch_pv_autosize.py``), on the
seeded thermal district (``synthetic.write_thermal_dataset`` with heating)
and the battery+PV district, with every ``autosize`` flag set by editing
the schema.

Tolerances. The sizes are equal to the bit: the same numpy operations in
the same dtypes. The autosized thermal district over 168 steps in the Gym
env is held as ``test_torch_parity_f64.py`` and ``test_torch_env.py``
hold the unsized one: 1e-6 of each series' scale in the float64 parity
mode (which reads ``capacity_npf32`` and ``capacity_weak``), 1e-5 in
float32."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _env_parity as ep
from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu_torch.compiler.schema import compile_schema, read_battery_choices
from citylearn_tpu_torch.data import DataSet
from citylearn_tpu_torch.synthetic import (
    write_battery_choices,
    write_battery_pv_dataset,
    write_epw,
    write_thermal_dataset,
)

DEVICES = ("electrical_storage", "pv", "cooling_device", "heating_device", "dhw_device",
           "cooling_storage", "heating_storage", "dhw_storage")
ROWS = 169


def autosize_everything(schema_path, devices=DEVICES):
    """Set ``autosize`` on every device block the schema has, point PV at
    a seeded ``weather.epw`` beside it, and rewrite ``schema.json``."""
    root = os.path.dirname(schema_path)
    write_epw(os.path.join(root, "weather.epw"), seed=4)
    with open(schema_path) as f:
        schema = json.load(f)
    for b in schema["buildings"].values():
        for key in devices:
            if b.get(key) is not None:
                b[key]["autosize"] = True
        if b.get("pv") is not None and "pv" in devices:
            b["pv"]["autosize_attributes"] = {"epw_filepath": "weather.epw"}
    with open(schema_path, "w") as f:
        json.dump(schema, f, indent=2)
    return schema_path


@pytest.fixture(scope="module")
def misc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("misc"))
    write_battery_choices(root, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CITYLEARN_MISC_ROOT", root)
        yield root


@pytest.fixture(scope="module")
def thermal(tmp_path_factory, misc_root):
    return autosize_everything(write_thermal_dataset(
        str(tmp_path_factory.mktemp("thermal")), 4, ROWS + 40, seed=3, heating=True))


@pytest.fixture(scope="module")
def battery(tmp_path_factory, misc_root):
    return autosize_everything(write_battery_pv_dataset(
        str(tmp_path_factory.mktemp("battery")), 5, 300, seed=1))


def both(path, **kw):
    return compile_schema(path, **kw), jax_compile(path, **kw)


def assert_fields_equal(ours, ref, where):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{where}.{f.name}")
        else:
            assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, f.name, a, b)


@pytest.mark.parametrize("window", [(0, None), (120, 160)])
def test_hvac_and_tank_sizes_equal_jax(thermal, window):
    start, end = window
    kw = dict(simulation_start_time_step=start)
    if end is not None:
        kw["simulation_end_time_step"] = end
    ours, ref = both(thermal, **kw)
    sized = 0
    for bo, br in zip(ours.buildings, ref.buildings):
        for key in ("cooling_device", "heating_device", "dhw_device", "cooling_storage",
                    "heating_storage", "dhw_storage", "battery"):
            assert_fields_equal(getattr(bo, key), getattr(br, key), f"{bo.name}.{key}")
        for key in ("cooling_storage", "heating_storage", "dhw_storage"):
            tank = getattr(bo, key)
            if tank.capacity_npf32:
                sized += 1
                assert tank.capacity > 0
        assert bo.pv_nominal_power == br.pv_nominal_power > 0
        np.testing.assert_array_equal(bo.series["solar_generation"],
                                      br.series["solar_generation"])
    assert sized >= 8            # every building's cooling and heating tanks
    # the sizes follow the window: the demand's peak over the simulation range
    whole, _ = both(thermal)
    if end is not None:
        sizes = lambda b: (b.cooling_device.nominal_power, b.heating_device.nominal_power,
                           b.dhw_device.nominal_power, b.cooling_storage.capacity,
                           b.heating_storage.capacity, b.dhw_storage.capacity)
        assert any(sizes(a) != sizes(b) for a, b in zip(ours.buildings, whole.buildings))


def test_battery_autosize_equals_jax(battery, misc_root):
    ours, ref = both(battery)
    choices = read_battery_choices()
    models = list(zip(choices["capacity"], choices["nominal_power"]))
    powers = set()
    for bo, br in zip(ours.buildings, ref.buildings):
        assert_fields_equal(bo.battery, br.battery, f"{bo.name}.battery")
        assert not bo.battery.capacity_weak and not bo.battery.dod_weak
        # a model's nominal power, a whole number of its units' capacity
        cap = bo.battery.capacity
        assert any(power == bo.battery.nominal_power and cap / unit == round(cap / unit) >= 1
                   for unit, power in models)
        powers.add(bo.battery.nominal_power)
        assert bo.pv_nominal_power == br.pv_nominal_power
    assert len(powers) > 1       # the seeded draw picks different models
    # the reference's table: DataSet's accessor reads the same columns
    assert DataSet().get_battery_sizing_data() == choices
    assert list(choices) == ["model", "capacity", "nominal_power", "depth_of_discharge",
                             "efficiency", "loss_coefficient", "capacity_loss_coefficient"]


def test_battery_autosize_smallest_model_when_none_fits(battery, tmp_path, monkeypatch):
    """No model's power fits the demand: the one of least nominal power."""
    with open(os.path.join(tmp_path, "battery_choices.yaml"), "w") as f:
        for name, power in (("Big_B", 90.0), ("Big_A", 50.0), ("Big_C", 70.0)):
            f.write(f"{name}:\n  attributes:\n    capacity: 100.0\n    nominal_power: "
                    f"{power}\n    depth_of_discharge: 0.9\n    efficiency: null\n"
                    f"    loss_coefficient: 0.002\n    capacity_loss_coefficient: 0.00001\n")
    monkeypatch.setenv("CITYLEARN_MISC_ROOT", str(tmp_path))
    ours, ref = both(battery)
    for bo, br in zip(ours.buildings, ref.buildings):
        assert_fields_equal(bo.battery, br.battery, f"{bo.name}.battery")
        assert bo.battery.nominal_power == 50.0 and bo.battery.capacity == 100.0
        assert 0.90 <= bo.battery.efficiency <= 0.98      # null: the seeded default


def test_battery_autosize_without_choices_raises(battery, monkeypatch, tmp_path):
    monkeypatch.setenv("CITYLEARN_MISC_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="battery_choices.yaml"):
        compile_schema(battery)


@pytest.mark.parametrize("parity_f64,tol", [(True, 1e-6), (False, 1e-5)])
def test_autosized_thermal_district_steps_equal_jax(thermal, parity_f64, tol):
    ours, ref = ep.pair(thermal, parity_f64=parity_f64, episode_time_steps=ROWS)
    ep.run_episode(ours, ref, ROWS - 1, seed=5, tol=tol)
    assert ours.terminated and ref.terminated
    ep.assert_history_close(ours, ref, tol)
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), tol)
    if parity_f64:
        cap = ours.params.cooling_storage.capacity
        assert cap.dtype == torch.float64 and float(cap.min()) > 0
