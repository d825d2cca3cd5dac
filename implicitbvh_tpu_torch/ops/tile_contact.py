"""Tile contact kernels and their plain versions.

Replaces, from ``implicitbvh_tpu/ops/tile_contact.py``:

- ``tile_run_counts`` (the two-phase route's count kernel, sphere and box
  masks, ``with_colmax``) and ``tile_group_emit`` (its emit kernel);
- ``tile_group_contacts`` (the pair-granularity fallback's grouped kernel)
  and ``tile_pair_contacts`` (the same per-pair slot compaction over a
  packed pair list, which no path calls), sphere and box masks on one field
  set.

Leaf fields arrive as one ``(F, T, G)`` float32 tensor: F = 4 (sphere
``x0, x1, x2, r``) or 6 (box ``lo0, lo1, lo2, up0, up1, up2``), T tiles of
G sorted leaves, padded leaves NaN so that every predicate on them is false.

All four kernels are bound by operations on the H100 (the leaf tests), not
by bytes.  The count and emit kernels keep the a-tile in shared memory and
one b-leaf per thread in registers; the slot kernels keep the b-tile in
shared memory and one a-row per thread.  Dead tiles and bands cost a
branch, counts are reduced and scanned in the block, and contacts are
written at scanned offsets, so none needs the TPU kernels' lane planes,
cursors or one-hot compaction.
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


# ---------------------------------------------------------------------------
# Per-pair contact slots: grouped kernel and packed pair-list kernel
# ---------------------------------------------------------------------------

def _check_slot_caps(ROW_CAP, CAP_PAIR):
    if ROW_CAP <= 0 or CAP_PAIR <= 0:
        raise ValueError(f"need ROW_CAP > 0 and CAP_PAIR > 0, got "
                         f"{ROW_CAP}, {CAP_PAIR}")


def _slot_contacts_plain(fields, ti, tj, band, live, *, mask_kind, ROW_CAP,
                         CAP_PAIR, dedup):
    """Row-major contact slots of the pairs ``(ti[e], tj[e])`` where
    ``live``: the s-th contact of a-row i (b-lane order), s < ROW_CAP, goes
    to lane ``row_off[i] + s`` if below CAP_PAIR.  Lanes that no contact
    fills hold -1.  Returns ``(gi, gj, counts, overflow)``."""
    n = ti.shape[0]
    G = fields.shape[2]
    dev = fields.device
    gi = torch.full((n, CAP_PAIR), -1, dtype=torch.int32, device=dev)
    gj = torch.full((n, CAP_PAIR), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for c in _chunks(live.nonzero().squeeze(1), G):
        tic, tjc = ti[c], tj[c]
        m = _pair_masks(fields, tic, tjc, band[c], N_BANDS, mask_kind, dedup)
        if dedup:          # global sorted order j > i: nothing when ti > tj
            m &= (tic <= tjc)[:, None, None]
        rc = m.sum(2, dtype=torch.int32)                      # (P, G) rows
        cnt = rc.sum(1, dtype=torch.int32)
        counts[c] = cnt
        overflow |= (cnt > CAP_PAIR).any() | (rc > ROW_CAP).any()
        hit = cnt > 0
        c, m, rc, tic, tjc = c[hit], m[hit], rc[hit], tic[hit], tjc[hit]
        row_off = torch.cumsum(rc, 1, dtype=torch.int32) - rc
        rank = torch.cumsum(m, 2, dtype=torch.int32) - 1
        lane = row_off[:, :, None] + rank
        keep = m & (rank < ROW_CAP) & (lane < CAP_PAIR)
        p, i, j = keep.nonzero(as_tuple=True)
        dst = (c[p], lane[p, i, j].long())
        gi[dst] = (tic[p] * G + i).int()
        gj[dst] = (tjc[p] * G + j).int()
    return gi, gj, counts, overflow


def tile_group_contacts_plain(a_idx, b_idx, nsteps, fields, *, mask_kind,
                              ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Plain PyTorch version of :func:`tile_group_contacts` (every lane
    that no contact fills holds -1)."""
    S_cap, T = a_idx.shape[0], fields.shape[1]
    step = torch.arange(b_idx.shape[0], device=b_idx.device) // \
        (b_idx.shape[0] // S_cap)
    ti = a_idx[step]
    tj = b_idx & 0xFFFF
    band = (b_idx >> 16) & ((1 << N_BANDS) - 1)
    live = (step < nsteps.clamp(max=S_cap)) & (band != 0) & (ti < T) & \
        (tj < T)
    return _slot_contacts_plain(fields, ti, tj, band, live,
                                mask_kind=mask_kind, ROW_CAP=ROW_CAP,
                                CAP_PAIR=CAP_PAIR, dedup=dedup)


def tile_group_contacts(a_idx, b_idx, nsteps, fields, *, mask_kind,
                        ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Padded per-pair contact slots of a grouped pair list.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``b_idx``: (S_cap*W,) int32 entries ``tj | band << 16``: b-tile and
      the 4-bit mask of the a-tile's live bands (G/4 rows each); pad
      entries carry band 0 (and ``tj = T``) and match nothing.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``fields``: (F, T, G) float32 leaf fields.
    - ``dedup``: keep only ``tj*G + j > ti*G + i`` (self-contact).

    Returns ``(gi, gj, counts, overflow)``: (S_cap*W, CAP_PAIR) int32 slots
    of global sorted positions ``ti*G + i`` and ``tj*G + j``, row-major (the
    s-th contact of a-row i in b-lane order, s < ROW_CAP, at lane
    ``row_off[i] + s`` if below CAP_PAIR, ``row_off`` the exclusive prefix
    of the uncapped row counts); the uncapped contact count of each entry,
    (S_cap*W,) int32; and a 0-dim bool, set when a count exceeds CAP_PAIR
    or a row ROW_CAP.  Lanes below ``min(count, CAP_PAIR)`` that no contact
    fills (those of a row's contacts past ROW_CAP) hold -1; lanes past the
    count are undefined.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_group_contacts``
    (``_group_kernel``, ``_pair_compact_vrows``).  On the H100 it is bound
    by operations (the live bands' leaf tests); ``csrc/group_contacts.cu``
    runs one block per entry, one thread per a-row, counts in one pass and
    writes the slots in a second pass over the pairs with contacts only.
    """
    _check_fields(fields, mask_kind)
    _check_slot_caps(ROW_CAP, CAP_PAIR)
    dev = fields.device
    S_cap = a_idx.shape[0]
    if S_cap == 0 or b_idx.shape[0] % S_cap:
        raise ValueError("b_idx length must be a multiple of len(a_idx)")
    SW = b_idx.shape[0]
    _build.check(a_idx, "a_idx", torch.int32, (S_cap,), dev)
    _build.check(b_idx, "b_idx", torch.int32, (SW,), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    kw = dict(mask_kind=mask_kind, ROW_CAP=ROW_CAP, CAP_PAIR=CAP_PAIR,
              dedup=dedup)
    if not _build.cuda_device(fields):
        return tile_group_contacts_plain(a_idx, b_idx, nsteps, fields, **kw)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_contacts", "group_contacts_launch",
                          [P] * 8 + [I] * 8 + [P])
    gi, gj, counts, over = _slot_outputs(SW, CAP_PAIR, dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "group_contacts", a_idx.data_ptr(),
                      b_idx.data_ptr(), nsteps.data_ptr(), fields.data_ptr(),
                      gi.data_ptr(), gj.data_ptr(), counts.data_ptr(),
                      over.data_ptr(), S_cap, SW // S_cap, fields.shape[1],
                      fields.shape[2], int(mask_kind == "box"), int(dedup),
                      ROW_CAP, CAP_PAIR)
    tile_group_contacts.launches += 1
    return gi, gj, counts, over[0] > 0


tile_group_contacts.launches = 0


def _slot_outputs(n, CAP_PAIR, dev):
    """Slot outputs of the slot kernels: the kernel fills every lane below
    a pair's count and CAP_PAIR, and lanes past the count are never read,
    so the slots are left unfilled."""
    return (torch.empty((n, CAP_PAIR), dtype=torch.int32, device=dev),
            torch.empty((n, CAP_PAIR), dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def tile_pair_contacts_plain(packed, npairs, fields, *, mask_kind,
                             ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Plain PyTorch version of :func:`tile_pair_contacts` (every lane
    that no contact fills holds -1)."""
    T = fields.shape[1]
    ti = (packed >> 16) & 0xFFFF
    tj = packed & 0xFFFF
    e = torch.arange(packed.shape[0], device=packed.device)
    live = (e < npairs.clamp(max=packed.shape[0])) & (ti < T) & (tj < T)
    band = torch.full_like(ti, (1 << N_BANDS) - 1)
    return _slot_contacts_plain(fields, ti, tj, band, live,
                                mask_kind=mask_kind, ROW_CAP=ROW_CAP,
                                CAP_PAIR=CAP_PAIR, dedup=dedup)


def tile_pair_contacts(packed, npairs, fields, *, mask_kind, ROW_CAP=4,
                       CAP_PAIR=16, dedup=True):
    """Padded per-pair contact slots of a packed pair list.

    - ``packed``: (P_cap,) int32 pairs ``ti << 16 | tj`` (int32 wrap-around
      for ``ti >= 32768``).
    - ``npairs``: (1,) int32 live pairs (read on the device).
    - ``fields``: (F, T, G) float32 leaf fields.

    Every a-row is tested (no bands); otherwise as
    :func:`tile_group_contacts`, one pair per entry.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_pair_contacts``
    (``_pair_kernel``).  No path of either package calls it; it is the
    second entry point of ``csrc/group_contacts.cu``.
    """
    _check_fields(fields, mask_kind)
    _check_slot_caps(ROW_CAP, CAP_PAIR)
    dev = fields.device
    P_cap = packed.shape[0]
    _build.check(packed, "packed", torch.int32, (P_cap,), dev)
    _build.check(npairs, "npairs", torch.int32, (1,), dev)
    kw = dict(mask_kind=mask_kind, ROW_CAP=ROW_CAP, CAP_PAIR=CAP_PAIR,
              dedup=dedup)
    if not _build.cuda_device(fields):
        return tile_pair_contacts_plain(packed, npairs, fields, **kw)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_contacts", "pair_contacts_launch",
                          [P] * 7 + [I] * 7 + [P])
    gi, gj, counts, over = _slot_outputs(P_cap, CAP_PAIR, dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "pair_contacts", packed.data_ptr(),
                      npairs.data_ptr(), fields.data_ptr(), gi.data_ptr(),
                      gj.data_ptr(), counts.data_ptr(), over.data_ptr(),
                      P_cap, fields.shape[1], fields.shape[2],
                      int(mask_kind == "box"), int(dedup), ROW_CAP, CAP_PAIR)
    tile_pair_contacts.launches += 1
    return gi, gj, counts, over[0] > 0


tile_pair_contacts.launches = 0
