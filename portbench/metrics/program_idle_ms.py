"""Milliseconds per profiled step in which the device is idle (the
profiler's timeline, ``Trace.idle_gaps``) while the host is inside one of
the program's spans: idle time the program's own host work leaves."""

from portbench import spans


def read(tr):
    inside = spans.union((s["start_ns"], s["end_ns"])
                         for s in spans.in_window(tr))
    if not inside or not tr.device_ops:
        return None
    gaps = [list(g) for g in tr.idle_gaps()]
    return spans.overlap_ns(inside, gaps) / tr.steps / 1e6
