"""Device kernels that one replay of the EV step's CUDA graph runs: the
kernels of the traced call's ``cudaGraphLaunch`` calls made inside a
``district_step`` span, tied to them by the trace's correlation ids, over
the number of those launches. None where no step ran on a graph."""


def read(run):
    n = run.counters.get("step_replays")
    return run.counters["step_replay_kernels"] / n if n else None
