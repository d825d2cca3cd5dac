"""Share of the profiled window in which no operation runs on the device
(the profiler's timeline)."""


def read(tr):
    lo, hi = tr.window_ns
    if hi <= lo or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / (hi - lo))
