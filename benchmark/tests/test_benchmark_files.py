"""The harness finds each cell's files by name, BENCHMARK.json keeps the
contract's shape, and a new cell needs new files and entries only."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_config_traffic_entry_and_readers(workload):
    cell = harness.find_cell(BENCH, workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert (harness.HERE / "entries" / f"{cell.traffic['entry']}.py").exists()
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and Path(harness.ROOT, c["file"]).exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """A dummy configuration, traffic mix and per-layer metric, added as
    files beside copies of the benchmark's own, load by name alone."""
    root = tmp_path
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (root / "benchmark/configs/dummy_district.json").write_text(json.dumps(
        {"name": "dummy_district", "writer": "write_battery_pv_dataset", "n_buildings": 2,
         "n_rows": 48}))
    (root / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(
        {"entry": "gym", "warmup_steps": 4, "trace_steps": 8, "limits": {"obs_gap": 1e-4}}))
    (root / "benchmark/metrics/dummy_share.py").write_text(
        "def read(run):\n    return run.counters.get('dummy')\n")
    bench["configs"].append({"name": "dummy_district", "source": "https://example.org/d",
                             "file": "benchmark/configs/dummy_district.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_district.dummy_mix", "config": "dummy_district",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0].pop("workloads", None)
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "setup_s", "workloads": ["dummy_district.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(harness.load_benchmark(root), "dummy_district.dummy_mix", root)
    assert cell.config["n_rows"] == 48 and cell.traffic["entry"] == "gym"
    assert [m["name"] for m in cell.per_layer] == ["dummy_share"]
    run = harness.Run()
    run.add("dummy", 3.0)
    assert harness.load_reader("dummy_share", root)(run) == 3.0


def test_readers_leave_out_what_they_cannot_read():
    empty = harness.Run()
    for m in BENCH["per_layer"]:
        assert harness.load_reader(m["name"])(empty) is None, m["name"]


def test_busy_time_is_the_union_of_device_intervals():
    run = harness.Run(device_ops=[("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0),
                                  ("d", 9.0, 12.0)], trace_window=(0.0, 10.0))
    assert run.busy_s() == pytest.approx(5.0)
    gaps = harness.breakdown(run)["idle_gaps"]
    assert sum(v for _, v in gaps) == pytest.approx(5.0)
