"""The readings that a cell's limits are set from, at the cell's own size:
the program's (sound runs) and those of the control and of the faults,
each put in the program's place, on each seed given.

    python3 -m benchmark.controls --workload <name> --seeds 1 2 3 [--what ...]

Training cells: ``program`` is a run with no timed window: set-up, the
calls on to the episode's end, then the reference; ``tf32`` is the
reference with every matrix product rounded to TF32 (the control);
``frozen_state``, ``half_batch`` and ``altered_answer`` plant a fault in
the reference: an update that leaves the networks unchanged, half of
every batch left out, a collected reward altered where it is made (these
run the first three calls only, so they give no ``reset_gap``). The Gym
cell: ``bf16`` is the
reference episode computed in bfloat16 (the control); ``frozen_state`` a
step that leaves the battery unchanged, ``altered_answer`` a reward
altered where it is made. One JSON line a reading; the benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.entries import sac_train
from benchmark.reference import district

FAULTS = ("frozen_state", "half_batch", "altered_answer")


def training_readings(cell, seed: int, what: str, device) -> dict:
    root = tempfile.mkdtemp(prefix="bench-controls-")
    try:
        if what == "program":
            return sac_train.run_cell(cell, seed, 0.0, False, device)["readings"]
        job = sac_train.Job.of(cell.traffic)
        schema = sac_train.write_district(cell.config, seed, root)
        d = district.load(schema)
        obs_dim = district.encoded_width(d.observations)
        nets = sac_train.seeded_nets(job, len(d.buildings), obs_dim, seed, device)
        ref = sac_train.reference_record(schema, job, seed, nets, device)
        ctl = sac_train.reference_record(schema, job, seed, nets, device,
                                         precision="tf32" if what == "tf32" else "fp32",
                                         fault=None if what == "tf32" else what)
        return sac_train.readings(sac_train.as_program_record(ctl), ref, nets)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gym_readings(cell, seed: int, what: str) -> dict:
    from benchmark.entries import gym
    from benchmark.reference import env as ref_env

    root = tempfile.mkdtemp(prefix="bench-controls-")
    try:
        schema = sac_train.write_district(cell.config, seed, root)
        d = district.load(schema)
        S = d.n_rows - 1
        rng = np.random.default_rng(seed)
        table = (-1.0 + rng.random((S, len(d.buildings))) * 2.0).astype(np.float32)
        dtype = torch.bfloat16 if what == "bf16" else torch.float32
        fault = None if what == "bf16" else what
        run = ref_env.episode(d, table, dtype, fault)
        obs = ref_env.observations(d).astype(np.float64)
        if what == "bf16":
            obs = torch.tensor(obs).to(dtype).double().numpy()
        steps = [(0.0, pos, obs[pos + 1], run["rewards"][pos]) for pos in range(S)]
        names = [b.name for b in d.buildings]
        rows = [{"name": k.split("|")[0], "cost_function": k.split("|")[1], "value": v}
                for k, v in ref_env.kpis(d, run, names).items()]
        return gym.compare(d, table, steps, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+")
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda")
    gym_cell = cell.traffic["entry"] == "gym"
    whats = args.what or (["bf16", "frozen_state", "altered_answer"] if gym_cell
                          else ["program", "tf32", *FAULTS])
    for seed in args.seeds:
        for what in whats:
            t0 = time.perf_counter()
            if gym_cell:
                values = gym_readings(cell, seed, what)
            else:
                values = training_readings(cell, seed, what, device)
            print(json.dumps({"workload": cell.name, "seed": seed, "what": what,
                              "seconds": time.perf_counter() - t0, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
