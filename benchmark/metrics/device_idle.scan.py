"""The share of the traced stretch in which no operation ran on the
traced card, in %: one less the union of the trace's device intervals
over the stretch."""


def read(run):
    if not run.trace_window or not run.device_ops:
        return None
    window = run.trace_window[1] - run.trace_window[0]
    return 100.0 * (1.0 - run.busy_s() / window)
