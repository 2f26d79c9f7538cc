"""The per-step EV cell (``challenge2022_phase_all_plus_evs.sac_train``):
found by name from files alone, its metrics silent on an empty run, and a
run of it (on the CPU, at a small size) loading no JAX module; its
reference loads nothing of the program. The comparison against the
reference, the control and the faults are held at a small size by
``tests/test_torch_ev_district_reference.py``."""

import json

from benchmark import harness
from benchmark.tests.test_benchmark_isolation import _python

BENCH = harness.load_benchmark()
CELL = "challenge2022_phase_all_plus_evs.sac_train"
NEW_METRICS = {"district_step_ms.evs", "step_launches.evs", "step_kernels.evs",
               "step_device_ms.evs", "sac_update_ms.evs", "device_idle.evs",
               "update_launches.evs", "update_mfu.evs"}


def test_the_cell_is_found_by_name_from_files_alone():
    cell = harness.find_cell(BENCH, CELL)
    assert cell.chips == 1 and cell.traffic["entry"] == "sac_train_evs"
    c = cell.config
    assert c["name"] == "challenge2022_phase_all_plus_evs" and c["writer"] == "write_ev_dataset"
    assert (c["n_buildings"], c["n_chargers"], c["n_evs"], c["n_washing_machines"],
            c["n_rows"]) == (17, 8, 15, 1, 8760)
    (entry,) = [x for x in BENCH["configs"] if x["name"] == c["name"]]
    assert entry["reduced"] == [] and entry["source"] == c["source"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "train_dsteps_per_s"}
    assert {m["name"] for m in cell.per_layer} == NEW_METRICS
    for name in NEW_METRICS:
        assert harness.load_reader(name)(harness.Run()) is None


def test_the_replay_readers_read_the_counters():
    run = harness.Run(counters={"step_replays": 4.0, "step_replay_kernels": 2236.0,
                                "step_replay_busy_s": 0.0044})
    assert harness.load_reader("step_kernels.evs")(run) == 559.0
    assert abs(harness.load_reader("step_device_ms.evs")(run) - 1.1) < 1e-12


def test_the_update_readers_read_the_updates():
    # two updates of 2 ms, one launching 3 runtime calls inside its span
    # and one 1, and a launch outside both
    ops = [("scan_update", 10.0, 10.5, 1), ("scan_update", 11.0, 11.5, 1),
           ("cudaLaunchKernel", 10.1, 10.2, 0), ("cudaGraphLaunch", 10.2, 10.3, 0),
           ("cudaMemcpyAsync", 10.3, 10.4, 0), ("cudaGraphLaunch", 11.1, 11.2, 0),
           ("cudaLaunchKernel", 12.0, 12.1, 0)]
    run = harness.Run(host_ops=ops, spans={"scan_update": [0.002, 0.002]},
                      counters={"update_flops": 0.002 * harness.PEAK_FP32_FLOPS * 0.05})
    assert harness.load_reader("update_launches.evs")(run) == 2.0
    assert abs(harness.load_reader("update_mfu.evs")(run) - 5.0) < 1e-9


def test_a_run_and_its_reference_load_no_jax():
    code = """
import json, torch
from benchmark import controls_evs, faults_evs, harness
from benchmark.entries import sac_train_evs
from benchmark.reference import ev_district, train_scan_evs
cell = harness.find_cell(harness.load_benchmark(), "challenge2022_phase_all_plus_evs.sac_train")
cell.traffic.update(n_districts=8, hidden=[16, 16], batch_size=32, replay_slots=16, chunk=16,
                    episode_time_steps=30)
cell.config.update(n_buildings=4, n_chargers=3, n_evs=4, n_rows=100)
sac_train_evs.run_cell(cell, 3, 0.2, False, torch.device("cpu"))
print(json.dumps(harness.forbidden_modules()))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
from benchmark.frozen import synthetic_ev
from benchmark.reference import ev_district, train_scan_evs
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0].startswith("citylearn")
                        or n.split(".")[0] in ("jax", "jaxlib", "flax"))))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
