"""The port's PV autosize (``compiler/pv_autosize.py``) against the JAX
package's on a seeded EPW file (``synthetic.write_epw``): the EPW reader,
the solar position, the plane-of-array irradiance and the PVWatts AC
chain; the sampled design row against pandas' ``DataFrame.sample``; the
sizing on the synthetic design table and on a small CSV of the LBL
Tracking-the-Sun columns (with empty ``module_area`` cells), with the
sizing options; the PySAM branch with a fake ``PySAM.Pvwattsv8``, as
``tests/test_energyplus_adapter.py`` fakes it; and compiled PV-autosized
buildings against JAX's ``compile_schema``.

No tolerance: the port copies the JAX package's numpy, so every array
and size is equal to the bit."""

import json
import os
import sys
import types

import numpy as np
import pandas as pd
import pytest

from citylearn_tpu.compiler import pv_autosize as jpa
from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu_torch.compiler import pv_autosize as pa
from citylearn_tpu_torch.compiler.schema import compile_schema, read_csv_columns
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset, write_epw

LBL_ROWS = 40


@pytest.fixture(scope="module")
def epw_path(tmp_path_factory):
    return write_epw(str(tmp_path_factory.mktemp("epw") / "weather.epw"), seed=2)


@pytest.fixture(scope="module")
def lbl_csv(tmp_path_factory):
    """A small CSV of the LBL columns: a text column, empty module areas."""
    rs = np.random.RandomState(9)
    path = tmp_path_factory.mktemp("misc") / pa.LBL_PV_FILENAME
    with open(path, "w") as f:
        f.write("state,nameplate_capacity_module_1,inverter_loading_ratio,tilt_1,azimuth_1,"
                "bifacial_module_1,module_area,PV_system_size_DC\n")
        for i in range(LBL_ROWS):
            area = "" if i % 3 == 0 else f"{rs.uniform(1.6, 2.2):.3f}"
            f.write(f"{'CA' if i % 2 else 'TX'},{rs.choice([300, 350, 400])},"
                    f"{rs.uniform(1.05, 1.35):.4f},{rs.uniform(5, 35):.1f},"
                    f"{rs.uniform(120, 240):.1f},{int(rs.uniform() < 0.2)},{area},"
                    f"{rs.uniform(2, 12):.2f}\n")
    return str(path)


def test_epw_chain_equals_jax(epw_path):
    ours, ref = pa.read_epw(epw_path), jpa.read_epw(epw_path)
    assert set(ours) == set(ref) and len(ours["ghi"]) == 8760
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    args = (ref["latitude"], ref["longitude"], ref["timezone"], ref["day_of_year"],
            ref["local_hour"])
    for a, b in zip(pa.solar_position(*args), jpa.solar_position(*args)):
        np.testing.assert_array_equal(a, b)
    for tilt, azimuth, bifacial in ((25.0, 180.0, 0.0), (10.0, 135.0, 0.65), (35.0, 250.0, 0.0)):
        np.testing.assert_array_equal(pa.poa_irradiance(ours, tilt, azimuth, bifacial),
                                      jpa.poa_irradiance(ref, tilt, azimuth, bifacial))
        ac = pa.pvwatts_ac(ours, 4.0, 1.2, tilt, azimuth, bifacial)
        np.testing.assert_array_equal(ac, jpa.pvwatts_ac(ref, 4.0, 1.2, tilt, azimuth, bifacial))
    # a plausible yield at 37.7 N: daylight only, clipped at the inverter
    ac = pa.pvwatts_ac(ours, 1.0, 1.2, 25.0, 180.0)
    assert (ac >= 0).all() and ac.max() <= 1000.0 / 1.2 + 1e-6
    assert 900 < ac.sum() / 1000.0 < 1900


def test_synthetic_table_equals_jax():
    ours, ref = pa._synthetic_sizing_table(), jpa._synthetic_sizing_table()
    assert list(ours) == list(ref.columns)
    for k in ref.columns:
        np.testing.assert_array_equal(ours[k], ref[k].to_numpy(), err_msg=k)


@pytest.mark.parametrize("source", ["synthetic", "lbl"])
def test_sample_row_equals_pandas(source, lbl_csv):
    if source == "synthetic":
        ours, frame = pa._synthetic_sizing_table(), jpa._synthetic_sizing_table()
    else:
        ours, frame = read_csv_columns(lbl_csv), pd.read_csv(lbl_csv, low_memory=False)
    for seed in range(40):
        row = pa.sample_row(ours, seed)
        ref = frame.sample(1, random_state=seed).iloc[0].to_dict()
        assert list(row) == list(ref)
        for k, v in ref.items():
            if isinstance(v, str):
                assert row[k] == v, (seed, k)
            else:
                assert (row[k] == v) or (np.isnan(row[k]) and np.isnan(v)), (seed, k)


SIZINGS = {
    "zne": dict(),
    "zne-options": dict(zero_net_energy_proportion=0.85, safety_factor=1.1),
    "roof": dict(zero_net_energy_proportion=1.0, roof_area=12.0),
    "sample-target": dict(use_sample_target=True),
}


@pytest.mark.parametrize("source", ["synthetic", "lbl", "lbl-file"])
@pytest.mark.parametrize("sizing", sorted(SIZINGS))
def test_autosize_pv_equals_jax(epw_path, lbl_csv, monkeypatch, source, sizing):
    kw = SIZINGS[sizing]
    if source == "synthetic":
        ours_data, ref_data = pa._synthetic_sizing_table(), jpa._synthetic_sizing_table()
    elif source == "lbl":
        ours_data, ref_data = read_csv_columns(lbl_csv), pd.read_csv(lbl_csv, low_memory=False)
    else:        # found under CITYLEARN_MISC_ROOT
        monkeypatch.setenv("CITYLEARN_MISC_ROOT", os.path.dirname(lbl_csv))
        ours_data = ref_data = None
        assert len(pa.get_pv_sizing_data()["tilt_1"]) == LBL_ROWS
    for seed, demand in ((3, 6000.0), (11, 9000.0), (27, 4000.0)):
        ours = pa.autosize_pv(demand, epw_path, seed, sizing_data=ours_data, **kw)
        ref = jpa.autosize_pv(demand, epw_path, seed, sizing_data=ref_data, **kw)
        assert type(ours[0]) is float and ours[0] == ref[0] > 0, (seed, ours[0], ref[0])
        assert ours[1].dtype == ref[1].dtype == np.float32
        np.testing.assert_array_equal(ours[1], ref[1])


def _fake_pysam(monkeypatch, calls, failures=0):
    """A ``PySAM.Pvwattsv8`` whose model records its design and whose
    ``execute`` fails the first ``failures`` times."""

    class Model:
        def __init__(self):
            self.SystemDesign = types.SimpleNamespace()
            self.SolarResource = types.SimpleNamespace()
            self.Outputs = types.SimpleNamespace(ac=list(np.linspace(0.0, 300.0, 8760)))

        def execute(self):
            calls.append(dict(vars(self.SystemDesign),
                              epw=self.SolarResource.solar_resource_file))
            if len(calls) <= failures:
                raise RuntimeError("simulation failed")

    module = types.ModuleType("PySAM.Pvwattsv8")
    module.default = lambda name: Model() if name == "PVWattsNone" else None
    package = types.ModuleType("PySAM")
    package.Pvwattsv8 = module
    monkeypatch.setitem(sys.modules, "PySAM", package)
    monkeypatch.setitem(sys.modules, "PySAM.Pvwattsv8", module)


@pytest.mark.parametrize("failures", [0, 2, 3])
def test_pysam_branch_equals_jax(monkeypatch, failures):
    table, frame = pa._synthetic_sizing_table(), jpa._synthetic_sizing_table()
    ours_calls, ref_calls = [], []
    results = []
    for fn, data, calls in ((pa.autosize_pv, table, ours_calls),
                            (jpa.autosize_pv, frame, ref_calls)):
        _fake_pysam(monkeypatch, calls, failures)
        if failures == 3:
            with pytest.raises(RuntimeError, match="simulation failed"):
                fn(8000.0, "weather.epw", 5, sizing_data=data)
        else:
            results.append(fn(8000.0, "weather.epw", 5, sizing_data=data))
    assert len(ours_calls) == min(failures + 1, 3)
    assert ours_calls == ref_calls
    # the i-th try draws the design with seed + i
    for i, call in enumerate(ours_calls):
        row = frame.sample(1, random_state=5 + i).iloc[0]
        assert call["system_capacity"] == row["nameplate_capacity_module_1"] / 1000.0
        assert call["bifaciality"] == row["bifacial_module_1"] * 0.65
        assert call["epw"] == "weather.epw"
    if results:
        (n1, s1), (n2, s2) = results
        assert n1 == n2 and s1.dtype == s2.dtype == np.float32
        np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("attributes", [
    {}, {"roof_area": 15.0, "zero_net_energy_proportion": 0.9},
    {"use_sample_target": True}])
def test_compiled_pv_autosized_building_equals_jax(tmp_path, attributes):
    path = write_battery_pv_dataset(str(tmp_path), 3, 400, seed=6)
    write_epw(str(tmp_path / "site.epw"), seed=8)
    with open(path) as f:
        schema = json.load(f)
    for b in schema["buildings"].values():
        b["pv"]["autosize"] = True
        b["pv"]["autosize_attributes"] = {"epw_filepath": "site.epw", **attributes}
    schema["root_directory"] = str(tmp_path)
    # simulation windows shorter and longer than one EPW year
    for end in (200, 399):
        ours = compile_schema(dict(schema, simulation_end_time_step=end))
        ref = jax_compile(dict(schema, simulation_end_time_step=end))
        for bo, br in zip(ours.buildings, ref.buildings):
            assert bo.pv_nominal_power == br.pv_nominal_power > 0
            assert bo.series["solar_generation"].dtype == np.float32
            np.testing.assert_array_equal(bo.series["solar_generation"],
                                          br.series["solar_generation"])
            assert bo.observation_high == br.observation_high
    if not attributes:              # sized by each building's own demand
        assert len({b.pv_nominal_power for b in ours.buildings}) > 1
