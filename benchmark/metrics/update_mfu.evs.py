"""The SAC update's share of the card's fp32 peak on the EV district, in
%: the matrix products of one update of the 17 agents, from the frozen
count (``counts.sac_update_flops``), over the mean time of an update
(``sac_update_ms.evs``'s: the draws, the replay rows and ``sac_update``,
each timed between two synchronizes of the card) in the traced run's
synchronized stretch."""

from benchmark import harness


def read(run):
    flops, times = run.counters.get("update_flops"), run.spans.get("scan_update")
    if not flops or not times:
        return None
    return 100.0 * flops / (sum(times) / len(times)) / harness.PEAK_FP32_FLOPS
