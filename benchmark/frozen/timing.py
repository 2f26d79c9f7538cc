"""CUDA-event timers, copied unchanged from ``chip_smoke.py``'s
``time_cuda`` and ``time_graph`` at commit
9d3dc9dcb87c1d4e04504b157550827e94518679."""

from __future__ import annotations

import torch


def time_cuda(fn, n):
    """Milliseconds per call of ``fn`` over ``n`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_graph(fn, n, replays=3):
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph, replayed ``replays`` times after one warm-up, so that the
    host's time to launch does not count."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)
