"""Milliseconds of one per-step ``district_step`` of every district (the
EV district at the cell's D, called from ``BatchedSAC._scan_step``: on a
card a replay of the step's CUDA graph), each timed between two
synchronizes of the card, over the steps of the traced run's synchronized
stretch."""


def read(run):
    times = run.spans.get("district_step")
    return 1e3 * sum(times) / len(times) if times else None
