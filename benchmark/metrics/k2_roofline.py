"""K2's share of its roofline: the least time the card could take for the
traced launches (the larger of their operations over the fp32 peak and
their bytes over the HBM bandwidth, from the frozen counts) over the
device time of ``collect_kernel`` in the trace, in %."""

from benchmark import harness


def read(run):
    launches = run.info.get("k2_launches", [])
    seconds, n = run.kernel_seconds(lambda name: "collect_kernel" in name)
    if not launches or n != len(launches) or seconds <= 0:
        return None
    bound = sum(max(ops / harness.PEAK_FP32_FLOPS, nbytes / harness.PEAK_HBM_BYTES)
                for ops, nbytes in launches)
    return 100.0 * bound / seconds
