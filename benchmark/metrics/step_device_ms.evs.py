"""Device milliseconds of one replay of the EV step's CUDA graph: the
union of the intervals of the kernels each ``cudaGraphLaunch`` made
inside a ``district_step`` span ran (tied by correlation id), summed over
the traced call's replays and divided by their number. None where no
step ran on a graph."""


def read(run):
    n = run.counters.get("step_replays")
    return 1e3 * run.counters["step_replay_busy_s"] / n if n else None
