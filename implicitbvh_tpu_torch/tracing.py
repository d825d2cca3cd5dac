"""Spans and counters of ``implicitbvh_tpu_torch``: where a call's time goes,
stage by stage, and how often the host does what.

This module is the one place the program keeps spans and counters.

**Spans.** ``span(name, device, **attrs)`` is a context manager around one
stage of the work.  A recorded span keeps its name, its attributes, its
own id, the id of the span it opened under, a call id shared by every
span under one outermost span (a public ``build``, ``traverse`` or
``traverse_rays``), and its start and end on ``time.time_ns()``, the
clock of ``torch.profiler``'s records, so that a span can be laid over a
profiled timeline.  On a CUDA
device it also records a pair of timing events on the device's current
stream; under stream capture the events are external record nodes, so a
graph captured with tracing on times each stage again at every replay.
Device times are read by :func:`snapshot`, after one synchronisation:
nothing waits for the device while spans are recorded.  On the CPU a
span's device interval is its host interval.

Spans are recorded while a ``torch.profiler`` session records, or inside
:func:`enabled`.  Otherwise ``span`` makes one flag test and returns a
shared null context that records nothing and makes no torch or CUDA call.
A span adds no record of its own to the profiler's.  Recorded spans go
into a buffer of ``MAX_SPANS``; past that the oldest are dropped and
counted.  A graph replay runs no Python, so a captured step reports its
stages only if it was captured with tracing on.

The tile engine's stages (``traverse/tiles.py``) are the spans
``tiles.fields`` (each body's leaves tiled into field sets and tile
bounds; attribute ``bodies``, 1 or 2), ``tiles.phase1``, ``tiles.count``,
``tiles.regroup``, ``tiles.emit``, ``tiles.merge`` and ``tiles.finish``;
on the two-tree route each stage after ``tiles.fields`` carries
``pair=True``.

**Counters** are plain integers and always on; each is an addition at a
place where the host already works.  They accumulate over the process
until :func:`reset`:

- ``calls.build``, ``calls.traverse``: public calls (``traverse_rays``
  counts as a traverse); ``calls.tiles_pair``: two-tree calls of the tile
  engine, ``traverse_tiles_pair_fixed`` or ``traverse_tiles_pair`` (once
  a call, whatever its growth runs);
- ``tiles.grid_cells``: supertile-grid cells tested by the tile engine's
  phase 1, ``S1 * S2`` for two trees and the triangle ``S (S + 1) / 2``
  for one (known on the host);
- ``grow.runs``: fixed-capacity runs of the tile engine's growth loop;
  ``grow.capacity``, ``grow.slots``: runs that overflowed a buffer
  (overflow bit 0) or a slot cap (bit 1); ``grow.walks``: calls that ended
  in the leaf-vs-tree walk; ``grow.cold``: calls whose ``cache`` gave no
  grown slot caps or pair capacity;
- ``syncs.<site>``: reads of a device value on the host, by site
  (:func:`to_int`, :func:`to_bool`); ``syncs`` in :func:`snapshot` is
  their sum;
- ``walk.steps``, ``dfs.steps``, ``bfs.runs``: steps of the torch-op walk
  loops and runs of BFS's growth loop;
- ``launches.<kernel>``: launches of each hand-written kernel.

The recorder is meant for one thread: spans opened by two threads at once
may take each other as parents.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 16

_counts = collections.Counter()
_spans = collections.deque(maxlen=MAX_SPANS)
_open = []              # the spans open now, innermost last
_ids = itertools.count(1)
_calls = itertools.count(1)
_forced = 0             # depth of enabled() blocks
_dropped = 0


def is_on() -> bool:
    """Whether spans are recorded now: inside :func:`enabled`, or while a
    ``torch.profiler`` session records."""
    return bool(_forced or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def enabled():
    """Record spans inside this block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class _Null:
    """The span that records nothing (tracing off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


_NULL = _Null()


class Span:
    """One recorded stage: see the module's docstring.  ``set(**attrs)``
    adds attributes while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns",
                 "end_ns", "device", "stream", "events", "captured")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.device = device if device is not None and \
            torch.device(device).type == "cuda" else None
        self.events = None
        self.captured = False
        self.end_ns = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else next(_calls)
        if self.device is not None:
            # the current stream of the span's device: a capture records it
            self.stream = torch.cuda.current_stream(self.device)
            self.captured = torch.cuda.is_current_stream_capturing()
            self.events = tuple(
                torch.cuda.Event(enable_timing=True, external=self.captured)
                for _ in range(2))
            self.events[0].record(self.stream)
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _open.remove(self)
        if len(_spans) == MAX_SPANS:
            _dropped += 1
        _spans.append(self)
        return False

    def device_ms(self):
        """Milliseconds between the span's events on the device (its host
        interval on the CPU); None while a captured span has not been
        replayed.  Read after the device has finished (see
        :func:`snapshot`)."""
        if self.events is None:
            return (self.end_ns - self.start_ns) / 1e6
        try:
            return self.events[0].elapsed_time(self.events[1])
        except RuntimeError:        # captured, never replayed
            return None


def span(name: str, device=None, **attrs):
    """A context manager recording the stage ``name`` with the attributes
    ``attrs`` when tracing is on (see :func:`is_on`), with device timing
    when ``device`` is a CUDA device; otherwise a shared null context.
    A recording span is true and the null context false, so ``if s:
    s.set(...)`` builds attributes only when they are kept."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, device, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def to_int(value, site: str) -> int:
    """``int(value)``, counted as a host sync at ``site`` when ``value`` is
    a tensor."""
    if isinstance(value, torch.Tensor):
        _counts["syncs." + site] += 1
    return int(value)


def to_bool(value, site: str) -> bool:
    """``bool(value)``, counted as a host sync at ``site`` when ``value``
    is a tensor."""
    if isinstance(value, torch.Tensor):
        _counts["syncs." + site] += 1
    return bool(value)


def counters() -> dict:
    """Every counter, with ``syncs`` the sum of the ``syncs.<site>``
    counters."""
    out = dict(_counts)
    out["syncs"] = sum(v for k, v in _counts.items()
                       if k.startswith("syncs."))
    return out


def counter(name: str) -> int:
    """One counter of :func:`counters` (0 if never counted)."""
    return counters().get(name, 0)


def snapshot() -> dict:
    """The recorded spans and the counters.

    Returns ``{"spans": [...], "counters": counters(), "dropped": n}``;
    each span is a dict with ``name``, ``id``, ``parent`` (an id or None),
    ``call``, ``start_ns``, ``end_ns`` (``time.time_ns()``), ``host_ms``,
    ``device_ms`` (None for a captured span not yet replayed),
    ``captured`` and ``attrs``, in the order the spans closed.  Waits once
    for each device that spans timed."""
    spans = list(_spans)
    for dev in {s.device for s in spans if s.events is not None}:
        torch.cuda.synchronize(dev)
    out = [{"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
            "start_ns": s.start_ns, "end_ns": s.end_ns,
            "host_ms": (s.end_ns - s.start_ns) / 1e6,
            "device_ms": s.device_ms(), "captured": s.captured,
            "attrs": dict(s.attrs)} for s in spans]
    return {"spans": out, "counters": counters(), "dropped": _dropped}


def reset(prefix: str = ""):
    """Clear the recorded spans and the counters whose names start with
    ``prefix`` (all of them by default; the spans only then)."""
    global _dropped
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]
    if not prefix:
        _spans.clear()
        _dropped = 0
