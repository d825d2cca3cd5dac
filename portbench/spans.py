"""The program's own spans and counters (``implicitbvh_tpu_torch.tracing``)
as the per-layer readers of ``metrics/`` see them: the spans that lie in a
traced run's profiled stretch, where the profiler turns them on, and the
counters of the whole process (set-up, window and profiled stretch).

A program without the module reads None, and so does a run with nothing
to read."""

from __future__ import annotations


def _tracing():
    try:
        from implicitbvh_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def in_window(tr) -> list:
    """The spans of ``implicitbvh_tpu_torch.tracing.snapshot()`` that start
    and end within ``tr.window_ns`` (none without the module)."""
    tracing = _tracing()
    lo, hi = tr.window_ns
    if tracing is None or not tr.steps or hi <= lo:
        return []
    return [s for s in tracing.snapshot()["spans"]
            if lo <= s["start_ns"] and s["end_ns"] <= hi]


def device_ms_per_step(tr, names) -> float | None:
    """Device milliseconds per profiled step of the spans named in
    ``names``."""
    ms = [s["device_ms"] for s in in_window(tr) if s["name"] in names]
    if not ms or None in ms:
        return None
    return sum(ms) / tr.steps


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def per_call(name: str) -> float | None:
    """The counter ``name`` over the public traverse calls, over the whole
    process."""
    tracing = _tracing()
    if tracing is None:
        return None
    counts = tracing.counters()
    calls = counts.get("calls.traverse", 0)
    return counts.get(name, 0) / calls if calls else None
