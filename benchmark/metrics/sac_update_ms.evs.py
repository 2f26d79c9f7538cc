"""Milliseconds of one SAC update of the EV district's 17 agents at the
per-step cadence (``BatchedSAC._update``: the draws, the replay rows and
``sac_update``), each timed between two synchronizes of the card, over
the updates of the traced run's synchronized stretch."""


def read(run):
    times = run.spans.get("scan_update")
    return 1e3 * sum(times) / len(times) if times else None
