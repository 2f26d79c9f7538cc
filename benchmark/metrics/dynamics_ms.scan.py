"""Milliseconds of the LSTM's share of a ``district_step``: its
``dynamics_update`` (the channel window and the LSTM over it), each timed
between two synchronizes of the card, over the steps of the traced run's
synchronized stretch."""


def read(run):
    times = run.spans.get("dynamics_update")
    return 1e3 * sum(times) / len(times) if times else None
