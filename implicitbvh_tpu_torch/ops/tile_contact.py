"""Tile contact kernels and their plain versions.

Replaces, from ``implicitbvh_tpu/ops/tile_contact.py``:

- ``tile_run_counts`` (the two-phase route's count kernel, with colmax and,
  under ``moments``, the per-column words of the moment-decode route) and
  ``tile_group_emit`` (its emit kernel);
- ``tile_group_contacts`` (the pair-granularity fallback's grouped kernel)
  and ``tile_pair_contacts`` (the same per-pair slot compaction over a
  packed pair list, which no path calls).

Each takes one of four masks (``MASK_FIELD_COUNTS``): ``sphere`` and ``box``
(leaves against leaves, self-contact) and ``ray_sphere`` and ``ray_box``
(rays against leaves).  Fields arrive as ``(F, T, G)`` tensors, T tiles of G
sorted entries: the a set (rows, indexed by ``a_idx``) and the b set
(columns; the a set itself when ``b_fields`` is not given), both float32 or
both float64 (the caller widens a float32 set against a float64 one, which
is exact).  The kernels are templates on the value type and the plain
versions compute in the fields' dtype.  A sphere
is ``x0, x1, x2, r``, a box ``lo0, lo1, lo2, up0, up1, up2``, a ray ``p0,
p1, p2, d0, d1, d2``.  Padded entries are NaN, so that every predicate on
them is false.

All four kernels are bound on the H100 by the leaf tests, not by bytes.
The predicates are explicitly rounded (no FMA), so the count and slot
kernels are bound by the instruction rate: they run a persistent grid over
the live tile pairs only, keep one side of each tile pair as 16-byte records
in shared memory and k = 4, 2 or 1 leaves of the other per thread in
registers, so that one broadcast load feeds k tests; the emit kernel does
the same over the live entries that a one-block scan lists with their
output offsets.  Dead tiles and bands cost a branch, counts are reduced and
scanned in the team, and contacts are written at scanned offsets, so none
needs the TPU kernels' lane planes, cursors or one-hot compaction.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..volumes import _ray_box_test, _ray_sphere_test, _reciprocal
from . import _build

# mask_kind -> (fields of the a set, fields of the b set); the order is the
# kernels' kind number
MASK_FIELD_COUNTS = {"sphere": (4, 4), "box": (6, 6), "ray_box": (6, 6),
                     "ray_sphere": (6, 4)}
_KIND = {k: n for n, k in enumerate(MASK_FIELD_COUNTS)}
N_BANDS = 4        # coarse bands of the emit payload
WORD_LANES = 128   # row width of the moment-word plane
_CHUNK_TESTS = 1 << 24   # leaf tests per batch in the plain versions


def _check_fields(a_fields, b_fields, mask_kind, dedup):
    """Validate the two field sets; returns the b set (the a set when
    ``b_fields`` is None) and the kernels' ``value_bits``."""
    if mask_kind not in MASK_FIELD_COUNTS:
        raise ValueError(f"mask_kind must be one of "
                         f"{sorted(MASK_FIELD_COUNTS)}, got {mask_kind!r}")
    if b_fields is None:
        b_fields = a_fields
    value_bits = _build.check_values(a_fields, "a_fields")
    _build.check_values(b_fields, "b_fields", like=a_fields,
                        device=a_fields.device)
    G = a_fields.shape[-1]
    for f, name, n in zip((a_fields, b_fields), ("a_fields", "b_fields"),
                          MASK_FIELD_COUNTS[mask_kind]):
        if f.dim() != 3 or f.shape[0] != n or f.shape[2] != G:
            raise ValueError(f"{mask_kind} {name} must be ({n}, T, {G}), "
                             f"got {tuple(f.shape)}")
    if G % 32 or G > 1024:
        raise ValueError(f"tile size {G} must be a multiple of 32, <= 1024")
    if dedup and b_fields is not a_fields:
        raise ValueError("dedup (the j > i triangle) needs one field set")
    return b_fields, value_bits


def _pair_masks(a_fields, b_fields, ti, tj, band_bits, NB, mask_kind, dedup):
    """(P, G, G) contact masks of a-tiles ``ti`` vs b-tiles ``tj``, rows
    restricted to the live bands of ``band_bits`` (NB bands of G/NB rows),
    with the j > i dedup on diagonal pairs.  B-tiles past Tb match
    nothing."""
    Ta, G = a_fields.shape[1], a_fields.shape[2]
    Tb = b_fields.shape[1]
    a = a_fields[:, ti.long().clamp(max=Ta - 1)][:, :, :, None]  # (Fa,P,G,1)
    b = b_fields[:, tj.long().clamp(max=Tb - 1)][:, :, None, :]  # (Fb,P,1,G)
    if mask_kind == "sphere":
        dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
        rr = a[3] + b[3]
        m = dx * dx + dy * dy + dz * dz <= rr * rr
    elif mask_kind == "box":
        m = (a[3] >= b[0]) & (a[0] <= b[3])
        m &= (a[4] >= b[1]) & (a[1] <= b[4])
        m &= (a[5] >= b[2]) & (a[2] <= b[5])
    elif mask_kind == "ray_box":
        m = _ray_box_test(a[:3], [_reciprocal(a[3 + k]) for k in range(3)],
                         b[:3], b[3:])
    else:
        m = _ray_sphere_test(a[:3], a[3:], b[:3], b[3])
    rows = torch.arange(G, device=a_fields.device)
    live_row = ((band_bits[:, None] >> (rows // (G // NB))) & 1) != 0
    m = m & live_row[:, :, None] & (tj < Tb)[:, None, None]
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

def _check_runs(a_idx, run_idx, bm_words, nsteps, a_fields, R, NB):
    dev = a_fields.device
    S_cap = a_idx.shape[0]
    if S_cap == 0 or run_idx.shape[0] % S_cap:
        raise ValueError("run_idx length must be a multiple of len(a_idx)")
    if NB not in (4, 8, 16) or a_fields.shape[2] % NB or R % (32 // NB):
        raise ValueError(f"bad band layout NB={NB}, R={R}")
    _build.check(a_idx, "a_idx", torch.int32, (S_cap,), dev)
    SW = run_idx.shape[0]
    _build.check(run_idx, "run_idx", torch.int32, (SW,), dev)
    _build.check(bm_words, "bm_words", torch.int32, (R * NB // 32, SW), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    return S_cap, SW // S_cap


def tile_run_counts_plain(a_idx, run_idx, bm_words, nsteps, a_fields,
                          b_fields=None, *, mask_kind, R=8, NB=4,
                          dedup=False, moments=False):
    """Plain PyTorch version of :func:`tile_run_counts`."""
    if b_fields is None:
        b_fields = a_fields
    S_cap = a_idx.shape[0]
    SW = run_idx.shape[0]
    W = SW // S_cap
    T, G = b_fields.shape[1], a_fields.shape[2]
    TPW = 32 // NB
    dev = a_fields.device
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
    words = torch.zeros((SW * R, WORD_LANES), dtype=torch.int32,
                        device=dev) if moments else None
    idx = live.reshape(-1).nonzero().squeeze(1)
    ti, tj, bmt = ti.reshape(-1), tj.reshape(-1), bmt.reshape(-1)
    row = torch.arange(G, dtype=torch.int32, device=dev)[None, :, None]
    for c in _chunks(idx, G):
        m = _pair_masks(a_fields, b_fields, ti[c], tj[c], bmt[c], NB,
                        mask_kind, dedup)                     # (P, G, G)
        col = m.sum(1, dtype=torch.int32)                     # (P, G)
        counts[c] = col.sum(1, dtype=torch.int32)
        colmax[c] = col.amax(1)
        if moments:
            si = (m * row).sum(1, dtype=torch.int32)
            sq = (m * (row * row)).sum(1, dtype=torch.int32)
            words[c, :G] = (col << 23) | torch.where(col <= 2,
                                                     (si << 15) + sq, 0)
    if moments:
        return counts, colmax, words
    return counts, colmax


def run_live_pairs(run_idx, bm_words, nsteps, S_cap, Tb, *, R, NB):
    """(S_cap*W*R,) bool: the (step, w, t) tile pairs that
    :func:`tile_run_counts` tests (a live step, a non-zero band nibble, a
    b-tile below ``Tb``); on the card only their word rows are written."""
    SW = run_idx.shape[0]
    W = SW // S_cap
    TPW = 32 // NB
    t = torch.arange(R, device=run_idx.device)
    bmt = (bm_words[t // TPW].T >> (NB * (t % TPW))) & ((1 << NB) - 1)
    tj = (run_idx & 0xFFFF)[:, None] * R + t
    step = torch.arange(SW, device=run_idx.device) // W
    live = (bmt != 0) & (tj < Tb) & (step < nsteps.clamp(max=S_cap))[:, None]
    return live.reshape(-1)


def tile_run_counts(a_idx, run_idx, bm_words, nsteps, a_fields,
                    b_fields=None, *, mask_kind, R=8, NB=4, dedup=False,
                    moments=False):
    """Exact contact counts of every (step, w, t) tile pair of a run list.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``run_idx``: (S_cap*W,) int32 aligned run index (low 16 bits); b-tile
      ``t`` of slot ``k`` is ``run_idx[k] * R + t``.
    - ``bm_words``: (R*NB/32, S_cap*W) int32 band words, NB bits per tile,
      32/NB tiles per word; a zero tile is skipped.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``a_fields``, ``b_fields``: (Fa, Ta, G) and (Fb, Tb, G) field sets of
      the mask, both float32 or both float64 (``b_fields`` defaults to
      ``a_fields``).
    - ``dedup``: the j > i triangle on diagonal pairs (one field set only).

    Returns ``(counts, colmax)``, each (S_cap*W*R,) int32 in (step, w, t)
    order: a pair's contact count and its largest per-column count.  With
    ``moments`` (tiles of at most 128) it also returns the (S_cap*W*R, 128)
    int32 word plane: for b-column j of a pair, with cc hits at a-rows i,
    ``cc << 23 | (sum i << 15) + sum i^2`` when cc <= 2 and ``cc << 23``
    otherwise; lanes >= G are zero.  Only the rows of live pairs
    (:func:`run_live_pairs`) are defined: the kernel leaves the rows of dead
    pairs and pad steps unwritten (the plain version zeroes them), and the
    moment decode reads none of them.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_run_counts``
    (``_run_count_kernel``).  On the H100 it is bound by the instruction rate
    (the explicitly rounded leaf tests of the live bands, ``num_checks``);
    in ``csrc/run_counts.cu`` the teams of a persistent grid take the live
    pairs in groups from a counter, test k columns per thread against each
    a-row record they load and reduce each pair in the team; the grid
    zeroes the dead steps' counts itself, so every output is allocated
    uninitialised.
    """
    b_fields, value_bits = _check_fields(a_fields, b_fields, mask_kind,
                                         dedup)
    S_cap, W = _check_runs(a_idx, run_idx, bm_words, nsteps, a_fields, R, NB)
    G = a_fields.shape[2]
    if moments and G > WORD_LANES:
        raise ValueError(f"moments need a tile size <= {WORD_LANES}, got {G}")
    if not _build.cuda_device(a_fields):
        return tile_run_counts_plain(
            a_idx, run_idx, bm_words, nsteps, a_fields, b_fields,
            mask_kind=mask_kind, R=R, NB=NB, dedup=dedup, moments=moments)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("run_counts", "run_counts_launch",
                          [P] * 10 + [I] * 10 + [P])
    dev = a_fields.device
    counts = torch.empty(S_cap * W * R, dtype=torch.int32, device=dev)
    colmax = torch.empty_like(counts)
    words = torch.empty((S_cap * W * R, WORD_LANES), dtype=torch.int32,
                        device=dev) if moments else None
    work = torch.zeros(1, dtype=torch.int32, device=dev)  # the grid's queue
    with torch.cuda.device(dev):
        _build.launch(fn, "run_counts", a_idx.data_ptr(), run_idx.data_ptr(),
                      bm_words.data_ptr(), nsteps.data_ptr(),
                      a_fields.data_ptr(), b_fields.data_ptr(),
                      counts.data_ptr(), colmax.data_ptr(),
                      words.data_ptr() if moments else None, work.data_ptr(),
                      S_cap, W, R, NB,
                      a_fields.shape[1], b_fields.shape[1], G,
                      _KIND[mask_kind], int(dedup), value_bits)
    tracing.count("launches.tile_run_counts")
    if moments:
        return counts, colmax, words
    return counts, colmax



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


_PLAN_HEAD = 4   # the plan's header: total, flags, live entries, counter


def emit_plan_plain(b_idx, nsteps, *, S_cap, CAP_PAIR):
    """Plain PyTorch version of :func:`emit_plan` (entries and offsets past
    the live count hold 0)."""
    SW = b_idx.shape[0]
    offs, total = _emit_offsets(b_idx, nsteps, S_cap, SW // S_cap, CAP_PAIR)
    e = torch.arange(SW, device=b_idx.device)
    live = (((b_idx >> 20) & 0xFF) > 0) & \
        ((e // (SW // S_cap)) < nsteps.clamp(max=S_cap))
    idx = live.nonzero().squeeze(1)
    n = idx.shape[0]
    entries = torch.zeros(SW, dtype=torch.int32, device=b_idx.device)
    offsets = torch.zeros_like(entries)
    entries[:n] = idx.int()
    offsets[:n] = offs[idx]
    return entries, offsets, total, live.sum(dtype=torch.int32)


def emit_plan(b_idx, nsteps, *, S_cap, CAP_PAIR):
    """The emit kernel's plan of an emit list (B3's first launch).

    - ``b_idx``: (S_cap*W,) int32 emit entries (``cnt`` in bits 20-27).
    - ``nsteps``: (1,) int32 live steps (read on the device).

    Returns ``(entries, offsets, total, nlive)``: the first ``nlive`` of the
    (S_cap*W,) int32 ``entries`` are the live entries (``cnt > 0`` in a step
    below ``nsteps``) in order, and ``offsets`` their output offsets, the
    exclusive prefix of ``min(cnt, CAP_PAIR)`` over the live entries (as
    :func:`_emit_offsets`); ``total`` (0-dim int32) is its sum and
    ``nlive`` (0-dim int32) the live count.  On the card the lists past
    ``nlive`` are undefined.

    On the H100 one block of ``csrc/group_emit.cu`` scans the live steps'
    entries, 16 a thread per chunk; :func:`tile_group_emit` launches it
    before its emit kernel in the same call.
    """
    dev = b_idx.device
    _build.check(b_idx, "b_idx", torch.int32, (b_idx.shape[0],), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    SW = b_idx.shape[0]
    if S_cap <= 0 or SW % S_cap or not 0 < CAP_PAIR <= 128:
        raise ValueError(f"need S_cap dividing {SW} and 0 < CAP_PAIR <= 128")
    if not _build.cuda_device(b_idx):
        return emit_plan_plain(b_idx, nsteps, S_cap=S_cap, CAP_PAIR=CAP_PAIR)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_emit", "emit_plan_launch",
                          [P] * 3 + [I] * 4 + [P])
    plan = torch.empty(_PLAN_HEAD + 2 * SW, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "emit_plan", b_idx.data_ptr(), nsteps.data_ptr(),
                      plan.data_ptr(), S_cap, SW // S_cap, CAP_PAIR, 1)
    tracing.count("launches.emit_plan")
    pairs = plan[_PLAN_HEAD:].view(SW, 2)
    return pairs[:, 0], pairs[:, 1], plan[0], plan[2]



def tile_group_emit_plain(a_idx, b_idx, nsteps, a_fields, b_fields=None, *,
                          mask_kind, ROW_CAP=4, CAP_PAIR=32, dedup=False,
                          CAP=1 << 17):
    """Plain PyTorch version of :func:`tile_group_emit` (same offsets, same
    column-major order within a pair)."""
    if b_fields is None:
        b_fields = a_fields
    S_cap = a_idx.shape[0]
    W = b_idx.shape[0] // S_cap
    G = a_fields.shape[2]
    dev = a_fields.device
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
        m = _pair_masks(a_fields, b_fields, ti, tj, (bw >> 16) & 0xF,
                        N_BANDS, mask_kind, dedup)              # (P, G, G)
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


def tile_group_emit(a_idx, b_idx, nsteps, a_fields, b_fields=None, *,
                    mask_kind, ROW_CAP=4, CAP_PAIR=32, dedup=False,
                    CAP=1 << 17):
    """Dense contact stream of pre-counted tile pairs.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``b_idx``: (S_cap*W,) int32 entries ``tj | band << 16 | cnt << 20 |
      okc << 28``: b-tile, 4 coarse live bands, exact count (<= 255) and
      the colmax <= 2 flag; pad entries carry cnt = 0.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``a_fields``, ``b_fields``: (Fa, Ta, G) and (Fb, Tb, G) field sets of
      the mask, both float32 or both float64 (``b_fields`` defaults to
      ``a_fields``).

    Returns ``(gi, gj, total, flags)``: the first ``total`` entries of the
    (CAP,) int32 ``gi``/``gj`` are the global sorted positions of every
    contact (``ti*G + i`` in the a set, ``tj*G + j`` in the b set), pairs
    in entry order and column-major within a pair (at most
    ``min(cnt, CAP_PAIR)`` per pair).  ``flags`` bit 0: ``total > CAP``;
    bit 1: a pair with ``cnt >= 2`` and ``okc == 0`` has a row holding more
    than ``ROW_CAP`` contacts (with a ray mask a row is a ray).

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_group_emit``
    (``_group_emit_kernel``).  On the H100 it is bound by operations (the
    leaf tests of the live pairs' live bands).  ``csrc/group_emit.cu``
    lists the live entries with their offsets in one block
    (:func:`emit_plan`), then the teams of a persistent grid take the
    listed entries from a counter, test k b-columns per thread against each
    a-row record of the team's a-tile in shared memory, and write each
    column's first two contacts from registers (columns with more are
    tested again); the grid zeroes the streams past the total, so the
    outputs are one uninitialised allocation.
    """
    b_fields, value_bits = _check_fields(a_fields, b_fields, mask_kind,
                                         dedup)
    dev = a_fields.device
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
    if not _build.cuda_device(a_fields):
        return tile_group_emit_plain(a_idx, b_idx, nsteps, a_fields,
                                     b_fields, **kw)
    W = b_idx.shape[0] // S_cap
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_emit", "group_emit_launch",
                          [P] * 6 + [I] * 11 + [P])
    # gi, gj, then the plan: total, flags, live entries, work counter and
    # the (entry, offset) list
    out = torch.empty(2 * CAP + _PLAN_HEAD + 2 * b_idx.shape[0],
                      dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "group_emit", a_idx.data_ptr(), b_idx.data_ptr(),
                      nsteps.data_ptr(), a_fields.data_ptr(),
                      b_fields.data_ptr(), out.data_ptr(), S_cap, W,
                      a_fields.shape[1], b_fields.shape[1],
                      a_fields.shape[2], _KIND[mask_kind], int(dedup),
                      ROW_CAP, CAP_PAIR, CAP, value_bits)
    tracing.count("launches.tile_group_emit")
    return out[:CAP], out[CAP:2 * CAP], out[2 * CAP], out[2 * CAP + 1]



# ---------------------------------------------------------------------------
# Per-pair contact slots: grouped kernel and packed pair-list kernel
# ---------------------------------------------------------------------------

def _check_slot_caps(ROW_CAP, CAP_PAIR):
    if ROW_CAP <= 0 or CAP_PAIR <= 0:
        raise ValueError(f"need ROW_CAP > 0 and CAP_PAIR > 0, got "
                         f"{ROW_CAP}, {CAP_PAIR}")


def _slot_contacts_plain(a_fields, b_fields, ti, tj, band, live, *,
                         mask_kind, ROW_CAP, CAP_PAIR, dedup):
    """Row-major contact slots of the pairs ``(ti[e], tj[e])`` where
    ``live``: the s-th contact of a-row i (b-lane order), s < ROW_CAP, goes
    to lane ``row_off[i] + s`` if below CAP_PAIR.  Lanes that no contact
    fills hold -1.  Returns ``(gi, gj, counts, overflow)``."""
    n = ti.shape[0]
    G = a_fields.shape[2]
    dev = a_fields.device
    gi = torch.full((n, CAP_PAIR), -1, dtype=torch.int32, device=dev)
    gj = torch.full((n, CAP_PAIR), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for c in _chunks(live.nonzero().squeeze(1), G):
        tic, tjc = ti[c], tj[c]
        m = _pair_masks(a_fields, b_fields, tic, tjc, band[c], N_BANDS,
                        mask_kind, dedup)
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


def tile_group_contacts_plain(a_idx, b_idx, nsteps, a_fields, b_fields=None,
                              *, mask_kind, ROW_CAP=4, CAP_PAIR=16,
                              dedup=True):
    """Plain PyTorch version of :func:`tile_group_contacts` (every lane
    that no contact fills holds -1)."""
    if b_fields is None:
        b_fields = a_fields
    S_cap = a_idx.shape[0]
    step = torch.arange(b_idx.shape[0], device=b_idx.device) // \
        (b_idx.shape[0] // S_cap)
    ti = a_idx[step]
    tj = b_idx & 0xFFFF
    band = (b_idx >> 16) & ((1 << N_BANDS) - 1)
    live = (step < nsteps.clamp(max=S_cap)) & (band != 0) & \
        (ti < a_fields.shape[1]) & (tj < b_fields.shape[1])
    return _slot_contacts_plain(a_fields, b_fields, ti, tj, band, live,
                                mask_kind=mask_kind, ROW_CAP=ROW_CAP,
                                CAP_PAIR=CAP_PAIR, dedup=dedup)


def tile_group_contacts(a_idx, b_idx, nsteps, a_fields, b_fields=None, *,
                        mask_kind, ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Padded per-pair contact slots of a grouped pair list.

    - ``a_idx``: (S_cap,) int32 a-tile per step.
    - ``b_idx``: (S_cap*W,) int32 entries ``tj | band << 16``: b-tile and
      the 4-bit mask of the a-tile's live bands (G/4 rows each); pad
      entries carry band 0 (and ``tj = Tb``) and match nothing.
    - ``nsteps``: (1,) int32 live steps (read on the device).
    - ``a_fields``, ``b_fields``: (Fa, Ta, G) and (Fb, Tb, G) field sets of
      the mask, both float32 or both float64 (``b_fields`` defaults to
      ``a_fields``).
    - ``dedup``: keep only ``tj*G + j > ti*G + i`` (self-contact, one field
      set).

    Returns ``(gi, gj, counts, overflow)``: (S_cap*W, CAP_PAIR) int32 slots
    of global sorted positions ``ti*G + i`` (a set) and ``tj*G + j`` (b
    set), row-major (the
    s-th contact of a-row i in b-lane order, s < ROW_CAP, at lane
    ``row_off[i] + s`` if below CAP_PAIR, ``row_off`` the exclusive prefix
    of the uncapped row counts); the uncapped contact count of each entry,
    (S_cap*W,) int32; and a 0-dim bool, set when a count exceeds CAP_PAIR
    or a row ROW_CAP.  Lanes below ``min(count, CAP_PAIR)`` that no contact
    fills (those of a row's contacts past ROW_CAP) hold -1; lanes past the
    count are undefined.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_group_contacts``
    (``_group_kernel``, ``_pair_compact_vrows``).  On the H100 it is bound
    by the instruction rate (the live bands' explicitly rounded leaf tests);
    in ``csrc/group_contacts.cu`` the teams of a persistent grid take the
    live entries in groups from a counter, test k a-rows per thread (the
    a-tile prepared once for a step's W entries), count in one pass and
    write the slots in a second pass over the pairs with contacts only.
    """
    b_fields, value_bits = _check_fields(a_fields, b_fields, mask_kind,
                                         dedup)
    _check_slot_caps(ROW_CAP, CAP_PAIR)
    dev = a_fields.device
    S_cap = a_idx.shape[0]
    if S_cap == 0 or b_idx.shape[0] % S_cap:
        raise ValueError("b_idx length must be a multiple of len(a_idx)")
    SW = b_idx.shape[0]
    _build.check(a_idx, "a_idx", torch.int32, (S_cap,), dev)
    _build.check(b_idx, "b_idx", torch.int32, (SW,), dev)
    _build.check(nsteps, "nsteps", torch.int32, (1,), dev)
    kw = dict(mask_kind=mask_kind, ROW_CAP=ROW_CAP, CAP_PAIR=CAP_PAIR,
              dedup=dedup)
    if not _build.cuda_device(a_fields):
        return tile_group_contacts_plain(a_idx, b_idx, nsteps, a_fields,
                                         b_fields, **kw)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_contacts", "group_contacts_launch",
                          [P] * 9 + [I] * 10 + [P])
    gi, gj, counts, over = _slot_outputs(SW, CAP_PAIR, dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "group_contacts", a_idx.data_ptr(),
                      b_idx.data_ptr(), nsteps.data_ptr(),
                      a_fields.data_ptr(), b_fields.data_ptr(),
                      gi.data_ptr(), gj.data_ptr(), counts.data_ptr(),
                      over.data_ptr(), S_cap, SW // S_cap, a_fields.shape[1],
                      b_fields.shape[1], a_fields.shape[2], _KIND[mask_kind],
                      int(dedup), ROW_CAP, CAP_PAIR, value_bits)
    tracing.count("launches.tile_group_contacts")
    return gi, gj, counts, over[0] > 0



def _slot_outputs(n, CAP_PAIR, dev):
    """Slot outputs of the slot kernels: the kernel fills every lane below
    a pair's count and CAP_PAIR, and lanes past the count are never read,
    so the slots are left unfilled.  ``over`` holds the overflow flag and
    the grid's work counter."""
    return (torch.empty((n, CAP_PAIR), dtype=torch.int32, device=dev),
            torch.empty((n, CAP_PAIR), dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev))


def tile_pair_contacts_plain(packed, npairs, a_fields, b_fields=None, *,
                             mask_kind, ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Plain PyTorch version of :func:`tile_pair_contacts` (every lane
    that no contact fills holds -1)."""
    if b_fields is None:
        b_fields = a_fields
    ti = (packed >> 16) & 0xFFFF
    tj = packed & 0xFFFF
    e = torch.arange(packed.shape[0], device=packed.device)
    live = (e < npairs.clamp(max=packed.shape[0])) & \
        (ti < a_fields.shape[1]) & (tj < b_fields.shape[1])
    band = torch.full_like(ti, (1 << N_BANDS) - 1)
    return _slot_contacts_plain(a_fields, b_fields, ti, tj, band, live,
                                mask_kind=mask_kind, ROW_CAP=ROW_CAP,
                                CAP_PAIR=CAP_PAIR, dedup=dedup)


def tile_pair_contacts(packed, npairs, a_fields, b_fields=None, *, mask_kind,
                       ROW_CAP=4, CAP_PAIR=16, dedup=True):
    """Padded per-pair contact slots of a packed pair list.

    - ``packed``: (P_cap,) int32 pairs ``ti << 16 | tj`` (int32 wrap-around
      for ``ti >= 32768``).
    - ``npairs``: (1,) int32 live pairs (read on the device).
    - ``a_fields``, ``b_fields``: (Fa, Ta, G) and (Fb, Tb, G) field sets of
      the mask, both float32 or both float64 (``b_fields`` defaults to
      ``a_fields``).

    Every a-row is tested (no bands); otherwise as
    :func:`tile_group_contacts`, one pair per entry.

    Replaces ``implicitbvh_tpu/ops/tile_contact.py:tile_pair_contacts``
    (``_pair_kernel``).  No path of either package calls it; it is the
    second entry point of ``csrc/group_contacts.cu``.
    """
    b_fields, value_bits = _check_fields(a_fields, b_fields, mask_kind,
                                         dedup)
    _check_slot_caps(ROW_CAP, CAP_PAIR)
    dev = a_fields.device
    P_cap = packed.shape[0]
    _build.check(packed, "packed", torch.int32, (P_cap,), dev)
    _build.check(npairs, "npairs", torch.int32, (1,), dev)
    kw = dict(mask_kind=mask_kind, ROW_CAP=ROW_CAP, CAP_PAIR=CAP_PAIR,
              dedup=dedup)
    if not _build.cuda_device(a_fields):
        return tile_pair_contacts_plain(packed, npairs, a_fields, b_fields,
                                        **kw)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("group_contacts", "pair_contacts_launch",
                          [P] * 8 + [I] * 9 + [P])
    gi, gj, counts, over = _slot_outputs(P_cap, CAP_PAIR, dev)
    with torch.cuda.device(dev):
        _build.launch(fn, "pair_contacts", packed.data_ptr(),
                      npairs.data_ptr(), a_fields.data_ptr(),
                      b_fields.data_ptr(), gi.data_ptr(), gj.data_ptr(),
                      counts.data_ptr(), over.data_ptr(), P_cap,
                      a_fields.shape[1], b_fields.shape[1], a_fields.shape[2],
                      _KIND[mask_kind], int(dedup), ROW_CAP, CAP_PAIR,
                      value_bits)
    tracing.count("launches.tile_pair_contacts")
    return gi, gj, counts, over[0] > 0

