"""Two-phase tile contact: count and emit kernels, and their plain versions.

Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_run_counts`` (the
run-block count kernel, sphere and box masks, ``with_colmax``) and
``tile_group_emit`` (the emit kernel).  Leaf fields arrive as one
``(F, T, G)`` float32 tensor: F = 4 (sphere ``x0, x1, x2, r``) or 6 (box
``lo0, lo1, lo2, up0, up1, up2``), T tiles of G sorted leaves, padded
leaves NaN so that every predicate on them is false.

Both kernels are bound by operations on the H100 (the leaf tests), not by
bytes: each block keeps its a-tile in shared memory and each thread one
b-leaf in registers, and dead tiles and bands cost a branch.  The count
kernel reduces per block and writes the reduced counts and colmax; the
emit kernel writes at offsets scanned from the exact counts, so neither
needs the TPU kernels' lane planes, cursors or one-hot compaction.
"""

from __future__ import annotations

import torch

from . import _build

MASK_FIELD_COUNTS = {"sphere": 4, "box": 6}
N_BANDS = 4        # coarse bands of the emit payload
_CHUNK_TESTS = 1 << 24   # leaf tests per batch in the plain versions


def _check_fields(fields, mask_kind):
    if mask_kind not in MASK_FIELD_COUNTS:
        raise ValueError(f"mask_kind must be sphere or box, got {mask_kind!r}")
    _build.check(fields, "fields", torch.float32)
    if fields.dim() != 3 or fields.shape[0] != MASK_FIELD_COUNTS[mask_kind]:
        raise ValueError(f"{mask_kind} fields must be "
                         f"({MASK_FIELD_COUNTS[mask_kind]}, T, G), "
                         f"got {tuple(fields.shape)}")
    G = fields.shape[2]
    if G % 32 or G > 1024:
        raise ValueError(f"tile size {G} must be a multiple of 32, <= 1024")


def _pair_masks(fields, ti, tj, band_bits, NB, mask_kind, dedup):
    """(P, G, G) contact masks of a-tiles ``ti`` vs b-tiles ``tj``, rows
    restricted to the live bands of ``band_bits`` (NB bands of G/NB rows),
    with the j > i dedup on diagonal pairs.  Tiles past T match nothing."""
    F, T, G = fields.shape
    a = fields[:, ti.long()][:, :, :, None]                 # (F, P, G, 1)
    b = fields[:, tj.long().clamp(max=T - 1)][:, :, None, :]  # (F, P, 1, G)
    if mask_kind == "sphere":
        dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        rr = a[3] + b[3]
        m = dx * dx + dy * dy + dz * dz <= rr * rr
    else:
        m = (a[3] >= b[0]) & (a[0] <= b[3])
        m &= (a[4] >= b[1]) & (a[1] <= b[4])
        m &= (a[5] >= b[2]) & (a[2] <= b[5])
    rows = torch.arange(G, device=fields.device)
    live_row = ((band_bits[:, None] >> (rows // (G // NB))) & 1) != 0
    m &= live_row[:, :, None] & (tj < T)[:, None, None]
    if dedup:
        upper = rows[None, :] > rows[:, None]                 # j > i
        m &= (ti != tj)[:, None, None] | upper
    return m


def _chunks(idx, G):
    step = max(1, _CHUNK_TESTS // (G * G))
    return [idx[k:k + step] for k in range(0, idx.shape[0], step)]


# ---------------------------------------------------------------------------
# Count kernel
# ---------------------------------------------------------------------------

def _check_runs(a_idx, run_idx, bm_words, nsteps, fields, R, NB):
    dev = fields.device
    S_cap = a_idx.shape[0]
    if S_cap == 0 or run_idx.shape[0] % S_cap:
        raise ValueError("run_idx length must be a multiple of len(a_idx)")
    if NB not in (4, 8, 16) or fields.shape[2] % NB or R % (32 // NB):
        raise ValueError(f"bad band layout NB={NB}, R={R}")
    _build.check(a_idx, "a_idx", torch.int32, (S_cap,), dev)
    SW = run_idx.shape[0]
    _build.check(run_idx, "run_idx", torch.int32, (SW,), dev)
    _build.check(bm_words, "bm_words", torch.int32, (R * NB // 32, SW), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    return S_cap, SW // S_cap


def tile_run_counts_plain(a_idx, run_idx, bm_words, nsteps, fields, *,
                          mask_kind, R=8, NB=4, dedup=False):
    """Plain PyTorch version of :func:`tile_run_counts`."""
    S_cap = a_idx.shape[0]
    SW = run_idx.shape[0]
    W = SW // S_cap
    T, G = fields.shape[1], fields.shape[2]
    TPW = 32 // NB
    dev = fields.device
    slot = torch.arange(SW, device=dev)
    t = torch.arange(R, device=dev)
    words = bm_words[t // TPW].T                              # (SW, R)
    bmt = (words >> (NB * (t % TPW))) & ((1 << NB) - 1)
    tj = (run_idx & 0xFFFF)[:, None] * R + t
    live = (bmt != 0) & (tj < T)
    live &= ((slot // W) < nsteps.clamp(max=S_cap))[:, None]
    ti = a_idx[slot // W][:, None].expand(SW, R)
    counts = torch.zeros(SW * R, dtype=torch.int32, device=dev)
    colmax = torch.zeros(SW * R, dtype=torch.int32, device=dev)
    idx = live.reshape(-1).nonzero().squeeze(1)
    ti, tj, bmt = ti.reshape(-1), tj.reshape(-1), bmt.reshape(-1)
    for c in _chunks(idx, G):
        col = _pair_masks(fields, ti[c], tj[c], bmt[c], NB, mask_kind,
                          dedup).sum(1, dtype=torch.int32)    # (P, G)
        counts[c] = col.sum(1, dtype=torch.int32)
        colmax[c] = col.amax(1)
    return counts, colmax


def tile_run_counts(a_idx, run_idx, bm_words, nsteps, fields, *,
                    mask_kind, R=8, NB=4, dedup=False):
    """Exact contact counts of every (step, w, t) tile pair of a run list.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``run_idx``: (S_cap*W,) int32 aligned run index (low 16 bits); b-tile
      ``t`` of slot ``k`` is ``run_idx[k] * R + t``.
    - ``bm_words``: (R*NB/32, S_cap*W) int32 band words, NB bits per tile,
      32/NB tiles per word; a zero tile is skipped.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``fields``: (F, T, G) float32 leaf fields.

    Returns ``(counts, colmax)``, each (S_cap*W*R,) int32 in (step, w, t)
    order: a pair's contact count and its largest per-column count.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_run_counts``
    (``_run_count_kernel``).  On the H100 it is bound by operations (the
    leaf tests of the live bands, ``num_checks``); ``csrc/run_counts.cu``
    tests only those bands and reduces each pair in its block.
    """
    _check_fields(fields, mask_kind)
    S_cap, W = _check_runs(a_idx, run_idx, bm_words, nsteps, fields, R, NB)
    if not _build.cuda_device(fields):
        return tile_run_counts_plain(a_idx, run_idx, bm_words, nsteps,
                                     fields, mask_kind=mask_kind, R=R, NB=NB,
                                     dedup=dedup)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("run_counts", "run_counts_launch",
                          [P] * 7 + [I] * 8 + [P])
    dev = fields.device
    counts = torch.empty(S_cap * W * R, dtype=torch.int32, device=dev)
    colmax = torch.empty_like(counts)
    with torch.cuda.device(dev):
        _build.launch(fn, "run_counts", a_idx.data_ptr(), run_idx.data_ptr(),
                      bm_words.data_ptr(), nsteps.data_ptr(),
                      fields.data_ptr(), counts.data_ptr(),
                      colmax.data_ptr(), S_cap, W, R, NB, fields.shape[1],
                      fields.shape[2], int(mask_kind == "box"), int(dedup))
    tile_run_counts.launches += 1
    return counts, colmax


tile_run_counts.launches = 0


# ---------------------------------------------------------------------------
# Emit kernel
# ---------------------------------------------------------------------------

def _emit_offsets(b_idx, nsteps, S_cap, W, CAP_PAIR):
    """Per-entry output offsets (exclusive prefix sum of min(cnt, CAP_PAIR)
    over the live steps' entries) and their total, on the device."""
    e = torch.arange(b_idx.shape[0], device=b_idx.device)
    cnt = (b_idx >> 20) & 0xFF
    lim = torch.where((e // W) < nsteps.clamp(max=S_cap),
                      cnt.clamp(max=CAP_PAIR), 0)
    incl = torch.cumsum(lim, 0, dtype=torch.int32)
    return incl - lim.int(), incl[-1]


def _emit_flags(total, row_over, CAP):
    return (total > CAP).int() | ((row_over[0] > 0).int() << 1)


def tile_group_emit_plain(a_idx, b_idx, nsteps, fields, *, mask_kind,
                          ROW_CAP=4, CAP_PAIR=32, dedup=False, CAP=1 << 17):
    """Plain PyTorch version of :func:`tile_group_emit` (same offsets, same
    column-major order within a pair)."""
    S_cap = a_idx.shape[0]
    W = b_idx.shape[0] // S_cap
    G = fields.shape[2]
    dev = fields.device
    offs, total = _emit_offsets(b_idx, nsteps, S_cap, W, CAP_PAIR)
    gi = torch.zeros(CAP, dtype=torch.int32, device=dev)
    gj = torch.zeros(CAP, dtype=torch.int32, device=dev)
    row_over = torch.zeros(1, dtype=torch.int32, device=dev)
    e = torch.arange(b_idx.shape[0], device=dev)
    cnt = (b_idx >> 20) & 0xFF
    live = (cnt > 0) & ((e // W) < nsteps.clamp(max=S_cap))
    ar = torch.arange(G * G, device=dev)
    jj, ii = ar // G, ar % G                         # column-major order
    for c in _chunks(live.nonzero().squeeze(1), G):
        bw = b_idx[c]
        ti, tj = a_idx[c // W], bw & 0xFFFF
        m = _pair_masks(fields, ti, tj, (bw >> 16) & 0xF, N_BANDS,
                        mask_kind, dedup)                       # (P, G, G)
        slow = (cnt[c] >= 2) & (((bw >> 28) & 1) == 0)
        over = slow & (m.sum(2) > ROW_CAP).any(1)
        row_over |= over.any().int()
        mt = m.transpose(1, 2).reshape(-1, G * G)               # [j, i]
        rank = torch.cumsum(mt, 1, dtype=torch.int32) - 1
        lim = cnt[c].clamp(max=CAP_PAIR)
        o = offs[c][:, None] + rank
        keep = mt & (rank < lim[:, None]) & (o < CAP)
        p, k = keep.nonzero(as_tuple=True)
        gi[o[p, k].long()] = ti[p] * G + ii[k].int()
        gj[o[p, k].long()] = tj[p] * G + jj[k].int()
    return gi, gj, total, _emit_flags(total, row_over, CAP)


def tile_group_emit(a_idx, b_idx, nsteps, fields, *, mask_kind, ROW_CAP=4,
                    CAP_PAIR=32, dedup=False, CAP=1 << 17):
    """Dense contact stream of pre-counted tile pairs.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``b_idx``: (S_cap*W,) int32 entries ``tj | band << 16 | cnt << 20 |
      okc << 28``: b-tile, 4 coarse live bands, exact count (<= 255) and
      the colmax <= 2 flag; pad entries carry cnt = 0.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``fields``: (F, T, G) float32 leaf fields.

    Returns ``(gi, gj, total, flags)``: the first ``total`` entries of the
    (CAP,) int32 ``gi``/``gj`` are the global sorted positions of every
    contact, pairs in entry order and column-major within a pair (at most
    ``min(cnt, CAP_PAIR)`` per pair).  ``flags`` bit 0: ``total > CAP``;
    bit 1: a pair with ``cnt >= 2`` and ``okc == 0`` has a row holding more
    than ``ROW_CAP`` contacts.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_group_emit``
    (``_group_emit_kernel``).  On the H100 it is bound by operations (the
    leaf tests of the live pairs' live bands); ``csrc/group_emit.cu`` runs
    one block per live pair and writes at offsets scanned from the exact
    counts, in place of the TPU kernel's cursor and one-hot compaction.
    """
    _check_fields(fields, mask_kind)
    dev = fields.device
    S_cap = a_idx.shape[0]
    if S_cap == 0 or b_idx.shape[0] % S_cap:
        raise ValueError("b_idx length must be a multiple of len(a_idx)")
    if not 0 < CAP_PAIR <= 128 or CAP <= 0:
        raise ValueError(f"need 0 < CAP_PAIR <= 128 and CAP > 0, "
                         f"got {CAP_PAIR}, {CAP}")
    _build.check(a_idx, "a_idx", torch.int32, (S_cap,), dev)
    _build.check(b_idx, "b_idx", torch.int32, (b_idx.shape[0],), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    kw = dict(mask_kind=mask_kind, ROW_CAP=ROW_CAP, CAP_PAIR=CAP_PAIR,
              dedup=dedup, CAP=CAP)
    if not _build.cuda_device(fields):
        return tile_group_emit_plain(a_idx, b_idx, nsteps, fields, **kw)
    W = b_idx.shape[0] // S_cap
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_emit", "group_emit_launch",
                          [P] * 8 + [I] * 9 + [P])
    offs, total = _emit_offsets(b_idx, nsteps, S_cap, W, CAP_PAIR)
    gi = torch.zeros(CAP, dtype=torch.int32, device=dev)
    gj = torch.zeros(CAP, dtype=torch.int32, device=dev)
    row_over = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "group_emit", a_idx.data_ptr(), b_idx.data_ptr(),
                      nsteps.data_ptr(), offs.data_ptr(), fields.data_ptr(),
                      gi.data_ptr(), gj.data_ptr(), row_over.data_ptr(),
                      S_cap, W, fields.shape[1], fields.shape[2],
                      int(mask_kind == "box"), int(dedup), ROW_CAP, CAP_PAIR,
                      CAP)
    tile_group_emit.launches += 1
    return gi, gj, total, _emit_flags(total, row_over, CAP)


tile_group_emit.launches = 0
