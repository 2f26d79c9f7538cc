"""Runtime launches of one SAC update of the EV district's 17 agents at
the per-step cadence (``BatchedSAC._update``: the draws, the replay rows
and ``sac_update``): the CUDA runtime's kernel launches, copies, memsets
and graph launches whose host call starts inside a ``scan_update`` span
(host edges only) in the traced run's device-traced stretch, over the
number of those spans. An update on its CUDA graph makes a few dozen (the
replay rows' gathers, the draws and one ``cudaGraphLaunch``); an eager one
makes hundreds."""

import bisect

LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch")


def read(run):
    spans = sorted((s, e) for n, s, e, annotated in run.host_ops
                   if annotated and n == "scan_update")
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for name, s, _, annotated in run.host_ops:
        if not annotated and name.startswith(LAUNCHES):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s <= spans[i][1]
    return n / len(spans)
