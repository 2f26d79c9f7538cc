"""Milliseconds of one SAC update of every agent (``BatchedSAC._update``:
the replay rows and ``sac_update``), each timed to completion on the card,
over the updates of the traced run's stretch with spans."""


def read(run):
    times = run.spans.get("sac_update")
    return 1e3 * sum(times) / len(times) if times else None
