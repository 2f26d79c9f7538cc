"""The readings that the per-step EV cell's limits are set from, at the
cell's own size, by :mod:`benchmark.controls`' method: the program's (sound
runs) and those of the control and of the faults, each put in the
program's place, on each seed given.

    python3 -m benchmark.controls_evs --workload challenge2022_phase_all_plus_evs.sac_train --seeds 1 2 3 [--what ...]

``program`` is a run with no timed window: set-up, the calls on to the
episode's end, then the reference; ``tf32`` is the reference with every
matrix product of the SAC networks rounded to TF32 (the control);
``frozen_state``, ``half_batch`` and ``altered_action`` plant a fault of
the learner or the policy in the reference (an update that leaves the
networks unchanged, half of every batch left out, district 0's battery
action reversed where it is made), ``scalar_efficiency``,
``arrival_unforced``, ``machine_unloaded`` and ``close_soc_dropped`` one
of the EV district (the chargers' efficiency curves read as their scalar
efficiency, no EV's SOC set when it arrives, the washing machines' load
dropped, the EV reward's close-SOC terms weighed 0). The faults run
the first three calls only, so they give no ``reset_gap``. One JSON line a
reading; the benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from benchmark import harness
from benchmark.entries import sac_train_evs as entry
from benchmark.reference import ev_district
from benchmark.reference.train_scan_evs import FAULTS


def readings(cell, seed: int, what: str, device) -> dict:
    if what == "program":
        return entry.run_cell(cell, seed, 0.0, False, device)["readings"]
    root = tempfile.mkdtemp(prefix="bench-controls-")
    try:
        job = entry.Job.of(cell.traffic)
        schema = entry.write_district(cell.config, seed, root)
        d = ev_district.load(schema, device, job.episode_time_steps)
        B = d.n_buildings
        K = ev_district.observation_table(d).shape[1] // B
        nets = entry.seeded_nets(job, B, K, d.n_slots, seed, device)
        ctl = entry.reference_run(schema, job, seed, nets, device,
                                  precision="tf32" if what == "tf32" else "fp32",
                                  fault=None if what == "tf32" else what)
        ref = entry.reference_run(schema, job, seed, nets, device, actions=ctl.record.actions)
        return entry.readings(entry.as_program_record(ctl), ref, nets)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["program", "tf32", *FAULTS])
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        for what in args.what:
            t0 = time.perf_counter()
            values = readings(cell, seed, what, device)
            print(json.dumps({"workload": cell.name, "seed": seed, "what": what,
                              "seconds": time.perf_counter() - t0, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
