"""The 95th percentile of every step's host latency in the measured
window, in milliseconds, taken as the end-to-end ``step_p95_ms`` is, for
a cell whose steps the host paces."""

from portbench.harness import percentile


def read(tr):
    if not tr.latencies:
        return None
    return 1e3 * percentile(tr.latencies, 95)
