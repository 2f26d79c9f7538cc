"""The launch-count readers on hand-made runs: they count the CUDA
runtime's launches, copies, memsets and graph launches whose host call
starts inside their layer's span, and nothing else."""

import pytest

from benchmark import harness

# (name, start, end, annotated) as harness.device_trace and harness.spans
# leave them in Run.host_ops
RUNTIME = [
    ("cudaLaunchKernel", 1.10, 1.11, 0),
    ("cudaLaunchKernelExC", 1.20, 1.21, 0),
    ("cudaMemcpyAsync", 1.30, 1.31, 0),
    ("cudaMemsetAsync", 1.40, 1.41, 0),
    ("cudaStreamIsCapturing", 1.50, 1.51, 0),     # no launch
    ("cudaLaunchKernel", 1.95, 2.05, 0),          # starts inside, ends outside
    ("cudaLaunchKernel", 2.50, 2.51, 0),          # between the spans
    ("cudaGraphLaunch", 3.10, 3.11, 0),
    ("cudaLaunchKernel", 3.20, 3.21, 0),
    ("cudaLaunchKernel", 3.99, 4.00, 0),
    ("cudaLaunchKernel", 0.50, 0.51, 0),          # before any span
    ("cudaLaunchKernel", 4.50, 4.51, 0),          # after every span
]


@pytest.mark.parametrize("metric, layer, other", [
    ("update_launches.train", "sac_update", "collect_chunk"),
    ("step_launches.env", "step_packed", "env_step"),
])
def test_launch_readers_count_the_runtime_launches_inside_their_spans(metric, layer, other):
    read = harness.load_reader(metric)
    host_ops = [(layer, 1.0, 2.0, 1), (layer, 3.0, 4.0, 1), (other, 0.0, 5.0, 1)] + RUNTIME
    # 5 launches start in the first span (the memset and the launch that
    # ends after it included), 3 in the second
    assert read(harness.Run(host_ops=host_ops)) == pytest.approx(8 / 2)
    # the outer span of another name alone gives no reading, nor do
    # launches outside every span
    assert read(harness.Run(host_ops=[(other, 0.0, 5.0, 1)] + RUNTIME)) is None
    assert read(harness.Run(host_ops=[(layer, 10.0, 11.0, 1)] + RUNTIME)) == 0.0
    # a runtime event named like the span is not a span
    assert read(harness.Run(host_ops=[(layer, 1.0, 2.0, 0)] + RUNTIME)) is None
