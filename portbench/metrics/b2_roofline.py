"""B2's share of its roofline: ``counts.b2``'s bound for the last
recorded call over the profiler's device time per record of
``run_counts_kernel``, in percent of the published H100 peaks."""

from portbench.counts import b2


def read(tr):
    call = tr.recorded.get("b2")
    ms, records = tr.kernel_ms(b2.KERNEL)
    if call is None or not records or ms <= 0:
        return None
    return 100.0 * b2.bound(*call)[0] / (ms / records)
