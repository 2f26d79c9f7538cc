"""The whole train step's share of the card's fp32 peak, in %: the
matrix products of the SAC updates and policy sweeps and K2's operations,
from the frozen counts, over the wall time of the traced run's plain
stretch (no device trace, no synchronizing span)."""

from benchmark import harness


def read(run):
    flops, seconds = run.counters.get("flops"), run.info.get("window_s")
    return 100.0 * flops / seconds / harness.PEAK_FP32_FLOPS if flops and seconds else None
