"""Mega-tile stream compaction: the CUDA kernel and its plain version.

Replaces ``implicitbvh_tpu/ops/compaction.py:tile_compact``
(``_compact_kernel``).  The flat mask is cut into 16,384-element
mega-tiles, each viewed as 128 rows of 128 lanes.  In mega-tile ``t`` the
``s``-th survivor of row ``r`` (``s < row_cap``) goes to slot
``row_off[r] + s`` when that slot is below ``cap``, where ``row_off`` is the
exclusive prefix of the uncapped row counts; ``counts[t]`` is the uncapped
survivor total.  Slots that nothing writes hold 0.  ``finish_compact``
flattens the padded slots into one list; ``compact_flat`` is the two in
one call, the form the fallback's phase 1 uses.

The kernels (``csrc/compact.cu``) are bound by bytes on the H100: one block
per mega-tile, one warp per row, ballots and popcounts for the row counts
and in-row ranks, a block scan of the 128 row counts, then one write per
kept survivor; ``compact_flat`` writes the survivors straight to their
places in the flat lists.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import _build

G = 128                  # a mega-tile is G rows of G lanes
MEGA = G * G


def _check_compact(mask, payloads, cap, row_cap):
    _build.check(mask, "mask", torch.bool)
    M = mask.shape[0]
    if mask.dim() != 1 or M == 0 or M % MEGA:
        raise ValueError(f"mask must be (M,) with M a positive multiple of "
                         f"{MEGA}, got {tuple(mask.shape)}")
    if len(payloads) != 2:
        raise ValueError(f"need two payloads, got {len(payloads)}")
    for q, p in enumerate(payloads):
        _build.check(p, f"payloads[{q}]", torch.int32, (M,), mask.device)
    if cap <= 0 or row_cap <= 0:
        raise ValueError(f"need cap > 0 and row_cap > 0, got {cap}, {row_cap}")
    return M // MEGA


def tile_compact_plain(mask, payloads, *, cap, row_cap):
    """Plain PyTorch version of :func:`tile_compact`."""
    tiles = mask.shape[0] // MEGA
    m = mask.view(tiles, G, G)
    mi = m.int()
    row_cnt = mi.sum(2, dtype=torch.int32)                   # (tiles, G)
    row_off = torch.cumsum(row_cnt, 1, dtype=torch.int32) - row_cnt
    rank = torch.cumsum(mi, 2, dtype=torch.int32) - mi       # in-row rank
    counts = row_cnt.sum(1, dtype=torch.int32)
    overflow = (counts > cap).any() | (row_cnt > row_cap).any()
    slot = row_off[:, :, None] + rank
    keep = m & (rank < row_cap) & (slot < cap)
    t = torch.arange(tiles, device=mask.device).view(tiles, 1, 1)
    dst = torch.where(keep, t * cap + slot, tiles * cap).reshape(-1)
    slots = []
    for p in payloads:
        out = torch.zeros(tiles * cap + 1, dtype=torch.int32,
                          device=mask.device)
        slots.append(out.scatter_(0, dst, p)[:-1].view(tiles, cap))
    return tuple(slots), counts, overflow


def tile_compact(mask, payloads, *, cap, row_cap):
    """Compact ``payloads`` where ``mask`` is set, per 16,384-element
    mega-tile.

    - ``mask``: (M,) bool, M a multiple of 16,384 (pad with False).
    - ``payloads``: a pair of (M,) int32 tensors.
    - ``cap``: slots per mega-tile; ``row_cap``: survivors kept per
      128-element row.

    Returns ``(slots, counts, overflow)``: a pair of (M/16384, cap) int32
    slot arrays, one per payload (unwritten slots 0); the uncapped survivor
    count of each mega-tile, (M/16384,) int32; and a 0-dim bool, set when a
    mega-tile holds more than ``cap`` survivors or a row more than
    ``row_cap``.

    Replaces ``implicitbvh_tpu/ops/compaction.py:tile_compact``.  On the
    H100 it is bound by bytes (the mask and payloads read, the slots
    written); ``csrc/compact.cu`` reads each row as four ballots and writes
    only the kept survivors into slots that the wrapper zeroes with
    ``torch.zeros``.
    """
    payloads = tuple(payloads)
    tiles = _check_compact(mask, payloads, cap, row_cap)
    if not _build.cuda_device(mask):
        return tile_compact_plain(mask, payloads, cap=cap, row_cap=row_cap)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("compact", "compact_launch",
                          [P] * 6 + [I] * 3 + [P])
    dev = mask.device
    slots = torch.zeros((2, tiles, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(tiles, dtype=torch.int32, device=dev)
    over = torch.empty(tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "compact", mask.data_ptr(), payloads[0].data_ptr(),
                      payloads[1].data_ptr(), slots.data_ptr(),
                      counts.data_ptr(), over.data_ptr(), tiles, cap,
                      row_cap)
    tracing.count("launches.tile_compact")
    return tuple(slots.unbind(0)), counts, over.any()



def finish_compact(slots, counts, capacity: int):
    """Flatten per-tile padded slots into one (capacity,) int32 list per
    payload (slot ``k`` of tile ``t`` is valid for ``k < counts[t]``, taken
    in flat order; targets at or past ``capacity`` are dropped) and the
    grand total of valid slots."""
    tiles, cap = slots[0].shape
    k = torch.arange(cap, device=counts.device)
    valid = (k[None, :] < counts[:, None]).reshape(-1)
    v = valid.int()
    pos = torch.cumsum(v, 0, dtype=torch.int32) - v
    dst = torch.where(valid & (pos < capacity), pos, capacity).long()
    outs = []
    for s in slots:
        out = torch.zeros(capacity + 1, dtype=torch.int32,
                          device=counts.device)
        outs.append(out.scatter_(0, dst, s.reshape(-1))[:capacity])
    return outs, v.sum(dtype=torch.int32)


def compact_flat_plain(mask, payloads, *, cap, row_cap, capacity):
    """Plain PyTorch version of :func:`compact_flat`: the composition of
    :func:`tile_compact_plain` and :func:`finish_compact`."""
    slots, counts, overflow = tile_compact_plain(mask, payloads, cap=cap,
                                                 row_cap=row_cap)
    outs, total = finish_compact(slots, counts, capacity)
    return tuple(outs), total, overflow


def compact_flat(mask, payloads, *, cap, row_cap, capacity: int):
    """:func:`tile_compact` and :func:`finish_compact` in one call.

    Returns ``(lists, total, overflow)``: a pair of (capacity,) int32 lists,
    one per payload, holding each mega-tile's first ``min(counts[t], cap)``
    slots in mega-tile order and then slot order (a row over ``row_cap``
    leaves zeros in its tile's range), zeros from the grand total on, and
    nothing at or past ``capacity``; the 0-dim int32 grand total
    ``sum(min(counts, cap))``, which may exceed ``capacity``; and the 0-dim
    bool overflow flag of :func:`tile_compact`.  Equal, bit for bit, to
    ``finish_compact(*tile_compact(...)[:2], capacity)`` and that flag.

    On the H100 (``csrc/compact.cu``) a count pass gives each mega-tile's
    count, and a write pass puts each kept survivor at its place in the
    flat lists (the mega-tile's base summed in the block from the counts
    before it) and zeroes the holes and the tail itself: one allocation and
    two launches, no slot arrays.
    """
    payloads = tuple(payloads)
    tiles = _check_compact(mask, payloads, cap, row_cap)
    if capacity <= 0:
        raise ValueError(f"need capacity > 0, got {capacity}")
    if not _build.cuda_device(mask):
        return compact_flat_plain(mask, payloads, cap=cap, row_cap=row_cap,
                                  capacity=capacity)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("compact", "compact_flat_launch",
                          [P] * 5 + [I] * 4 + [P])
    dev = mask.device
    # the two lists, then the per-tile counts and flags, the total and the
    # overflow flag (a 0 or 1 int, read as a bool through its first byte)
    buf = torch.empty(2 * capacity + 2 * tiles + 2, dtype=torch.int32,
                      device=dev)
    res = buf[2 * capacity:]
    with torch.cuda.device(dev):
        _build.launch(fn, "compact_flat", mask.data_ptr(),
                      payloads[0].data_ptr(), payloads[1].data_ptr(),
                      buf.data_ptr(), res.data_ptr(), tiles, cap, row_cap,
                      capacity)
    tracing.count("launches.compact_flat")
    return ((buf[:capacity], buf[capacity:2 * capacity]), res[2 * tiles],
            res[2 * tiles + 1:].view(torch.bool)[0])

