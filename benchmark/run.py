"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A run writes its seeded district under ``TMPDIR``, builds the cell's
program objects, warms them up (``setup_s`` counts all of this from the
process's start), measures for ``--seconds`` seconds, then checks what the
timed path produced against the plain reference. ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` reports its per-layer metrics,
read from spans around the calls into each layer and from a device trace.
The last line on standard output is one JSON object; the last lines on
standard error are the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    return entry.main(cell, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    # one process with few threads: the host's launch loop is what most
    # cells time, and idle worker threads only add noise to it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
