"""The tile engine: contact of one BVH with itself or with another BVH,
and (``traverse/ray_tiles.py``) ray queries, on the two-phase route or
the pair-granularity fallback.

Counterpart of ``implicitbvh_tpu/traverse/tiles.py``: Morton-sorted leaves
form tiles of G, and a supertile pass with the band-bit kernel
(``ops/subtile.py``) finds the candidate tile pairs: the upper triangle of
the tile grid for self-contact, the full grid of (tile of bvh1, tile of
bvh2) for two trees.  A front end (self and two trees here, the sharded
path of ``parallel/sharding.py`` on a rank's share, rays in
``traverse/ray_tiles.py``) fills a :class:`_TileQuery` and runs phase 1;
then one back end runs, chosen as in the JAX package (:func:`_two_phase`):

- **two-phase** (:func:`_two_phase_route`; ``pair_cap <= 128`` and
  ``capacity % 1024 == 0``): the pairs form aligned runs of R b-tiles;
  the count kernel (``ops/tile_contact.py``) counts each pair's contacts,
  the pairs with contacts are regrouped, and the emit kernel writes their
  contacts as one dense stream; with ``decode_k > 0`` the count kernel
  also writes per-column moment words, and the pairs whose columns hold
  at most two contacts each are decoded from those words
  (``_moment_decode``) and skip the emit kernel;
- **pair-granularity fallback** (:func:`_fallback_route`; otherwise,
  which includes every capacity of 1024 or less and every ``pair_cap``
  that slot-cap growth takes past 128): the compaction
  (``ops/compaction.py:compact_flat``) lists the pairs with their 4-bit
  band masks, the list is sorted and grouped W b-tiles per a-tile, the
  slot kernel (``tile_group_contacts``) writes each pair's padded contact
  slots, and each output slot gathers its contact from them.

User indices finish the list on both routes: sorted ``(min, max)`` pairs
for self-contact, tree order ``(index in bvh1, index in bvh2)`` for two
trees, where the kernels run without the j > i triangle on two field sets.
The capacity arithmetic is the JAX package's, copied so the overflow bits
and growth agree.  The fixed paths make no host sync: every count the
kernels need (live slots, steps, pairs) stays on the device.  Growth past
the slot caps' ceilings ends in the leaf-vs-tree walk (``traverse/lvt.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import tracing
from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..ops.compaction import compact_flat
from ..ops.grouping import scatter_drop, leader_group
from ..ops.subtile import subtile_band_bits
from ..ops.tile_contact import (N_BANDS, tile_group_contacts,
                                tile_group_emit, tile_run_counts)
from ..volumes import BSphere
from .lvt import _empty_traversal
from .types import BVHTraversal, LVTTraversal, TraversalAlgorithm

SS = 32                 # tiles per supertile
_SENTINEL = (1 << 31) - 1   # sorts after every live key


@dataclasses.dataclass(frozen=True)
class TileTraversal(TraversalAlgorithm):
    """Tile traversal parameters (the JAX package's ``TileTraversal``).

    - ``tile``: leaves per tile (G).
    - ``row_cap``: max contacts of one leaf within one other tile.
    - ``pair_cap``: max contacts within one tile pair.
    - ``run_r``: aligned b-tile run length (8, 16 or 32).
    - ``count_w``: run slots per count step sharing one a-tile.
    - ``emit_w``: b-tiles per emit step.
    - ``bands``: sub-bands per tile (4, 8 or 16).
    - ``decode_k``: on the two-phase route, pairs with at most this many
      contacts, at most two per column, are decoded from the count
      kernel's moment words in place of the emit kernel (0: none; needs
      ``tile <= 128``).  The fallback does not read it.
    """

    tile: int = 128
    row_cap: int = 4
    pair_cap: int = 32
    run_r: int = 8
    count_w: int = 8
    emit_w: int = 4
    bands: int = 4
    decode_k: int = 0


PAIRS_PER_TILE = 36
RAY_CANDS_PER_RAY_TILE = 448    # candidate leaf tiles per ray tile
SUPERPAIRS_PER_SUPERTILE = 24
MAX_ROW_CAP = 32
MAX_PAIR_CAP = 1024


def _pair_capacity_for(num_tiles: int) -> int:
    return max(((num_tiles * PAIRS_PER_TILE + 8191) // 8192) * 8192, 8192)


def _step_caps(need: int):
    """(S_cap, CHUNK) of a step list (the JAX package's rounding)."""
    CH_MAX = 1 << 14
    if need <= CH_MAX:
        s = max(256, -(-need // 256) * 256)
        return s, s
    return -(-need // CH_MAX) * CH_MAX, CH_MAX


def _run_chunk_cap(W: int, R: int, NB: int) -> int:
    NW = (R * NB) // 32
    words = 1 + W * (1 + NW)
    cap = 700_000 // (4 * words)
    return min(1 << 13, 1 << (cap.bit_length() - 1))


def _grow_capacity(capacity: int, growth: float, quantum: int = 1024) -> int:
    """Scale a capacity by ``growth``: powers of two up to 1024, multiples
    of ``quantum`` above.  Always grows."""
    new = max(int(capacity * growth), capacity + 1)
    if new <= 1024:
        return 1 << math.ceil(math.log2(new))
    return -(-new // quantum) * quantum


def _grow_alg(alg: TileTraversal) -> TileTraversal:
    """4x slot-cap growth under the ceilings."""
    return dataclasses.replace(
        alg, row_cap=min(4 * alg.row_cap, MAX_ROW_CAP),
        pair_cap=min(4 * alg.pair_cap, MAX_PAIR_CAP))


def _merge_cached_alg(alg: TileTraversal, cache) -> TileTraversal:
    """Adopt a previous result's (possibly grown) slot caps."""
    prev = getattr(cache, "tile_alg", None) if cache is not None else None
    if isinstance(prev, TileTraversal) and prev.tile == alg.tile:
        return dataclasses.replace(
            alg, row_cap=max(alg.row_cap, prev.row_cap),
            pair_cap=max(alg.pair_cap, prev.pair_cap))
    return alg


def _cumsum_compact(flat, values, cap, pad=0):
    """Compact ``values`` where ``flat`` into ``(cap,)``; (out, count)."""
    v = flat.int()
    pos = torch.cumsum(v, 0) - v
    out = scatter_drop(cap, torch.where(flat, pos, cap), values, pad)
    return out, v.sum(dtype=torch.int32)


def _wrap_int32(x64):
    """int64 values below 2^32 as int32 bit patterns (two's complement)."""
    return (x64 - ((x64 >> 31) & 1) * (1 << 32)).int()


def _popcount(x):
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _tiled_fields(bvh: BVH, G: int, NB: int = 4):
    """Leaf fields tiled to ``(F, T, G)`` (NaN padding: every predicate on
    a padded leaf is false), tile bounds ``(6, T)`` and sub-band bounds
    ``(6, T, NB)`` (rows lo0, lo1, lo2, up0, up1, up2; the finite ``big``
    padding never overlaps and keeps partial bands exact)."""
    vol = bvh.leaves.volume
    n = bvh.num_leaves
    T = -(-n // G)
    pad = T * G - n
    big = torch.finfo(vol.dtype).max
    if isinstance(vol, BSphere):
        raw = torch.stack([*vol.xs, vol.r])
        blo = torch.stack([x - vol.r for x in vol.xs])
        bup = torch.stack([x + vol.r for x in vol.xs])
        sphere = True
    else:
        raw = torch.stack([*vol.los, *vol.ups])
        blo, bup = torch.stack(vol.los), torch.stack(vol.ups)
        sphere = False
    fields = torch.nn.functional.pad(raw, (0, pad), value=float("nan"))
    fields = fields.view(-1, T, G)
    blo = torch.nn.functional.pad(blo, (0, pad), value=big).view(3, T, G)
    bup = torch.nn.functional.pad(bup, (0, pad), value=-big).view(3, T, G)
    tiles = torch.cat([blo.amin(2), bup.amax(2)])
    sub = torch.cat([blo.view(3, T, NB, G // NB).amin(3),
                     bup.view(3, T, NB, G // NB).amax(3)])
    return fields, sphere, tiles, sub, T


def _supertile_bounds(tiles):
    """(lo (3, S), up (3, S), S): bounds of the supertiles of SS tiles."""
    T = tiles.shape[1]
    S = -(-T // SS)
    pad = S * SS - T
    inf = float("inf")
    lo = torch.nn.functional.pad(tiles[:3], (0, pad), value=inf)
    up = torch.nn.functional.pad(tiles[3:], (0, pad), value=-inf)
    return lo.view(3, S, SS).amin(2), up.view(3, S, SS).amax(2), S


def _phase1_superpairs(tiles, P_cap: int, tiles_b=None, sp_round: int = 16):
    """Supertile-vs-supertile AABB overlap compacted to a superpair list:
    the upper triangle of one tile set's grid, or with ``tiles_b`` the full
    S1 x S2 grid of two sets.  ``SP_cap`` is rounded up to a multiple of
    ``sp_round`` (the sharded paths deal the list evenly over the ranks).
    Returns ``(si, sj, nsp, overflow)``."""
    lo1, up1, S1 = _supertile_bounds(tiles)
    lo2, up2, S2 = (lo1, up1, S1) if tiles_b is None \
        else _supertile_bounds(tiles_b)
    tracing.count("tiles.grid_cells",
                  S1 * (S1 + 1) // 2 if tiles_b is None else S1 * S2)
    ov = torch.ones((S1, S2), dtype=torch.bool, device=tiles.device)
    for k in range(3):
        ov &= (up1[k][:, None] >= lo2[k][None, :]) & \
              (lo1[k][:, None] <= up2[k][None, :])
    if tiles_b is None:
        ov &= torch.ones_like(ov).triu()
    SP_cap = max(max(S1, S2) * SUPERPAIRS_PER_SUPERTILE, 64, P_cap // 64)
    SP_cap = -(-SP_cap // sp_round) * sp_round
    kA = torch.arange(S1 * S2, dtype=torch.int32, device=tiles.device)
    spacked, nsp = _cumsum_compact(ov.reshape(-1), kA, SP_cap)
    return spacked // S2, spacked % S2, nsp, nsp > SP_cap


def _slice_runs(sub, tiles_b, si, sj, nsp, G: int, W: int, S_cap: int,
                R: int, pad_run: int, NB: int, triangle: bool):
    """A superpair slice ``(si, sj, nsp)`` -> band bits -> sorted,
    W-grouped aligned-run lists for the count kernel: sub-bands of the a
    tiles (``sub``) against the b tiles (``tiles_b``), under ``triangle``
    only the upper triangle.

    Returns ``(a_idx, run_idx, bm_words (NW, S_cap*W), nsteps,
    num_checks, overflow)``."""
    if R not in (8, 16, 32) or G % NB:
        raise ValueError(f"need run_r in (8, 16, 32) and tile % bands == 0")
    bits = subtile_band_bits(sub, tiles_b, si, sj, nsp.reshape(1),
                             triangle=triangle)
    SP_cap = bits.shape[0]
    NG = SS // R
    TPW = 32 // NB
    NW = R // TPW
    dev = bits.device
    shifts = NB * torch.arange(TPW, device=dev)
    w64 = (bits.view(SP_cap, SS, NG, NW, TPW).long() << shifts).sum(-1)
    words = _wrap_int32(w64)
    num_checks = (_popcount(bits).sum().to(torch.float32)
                  * float((G // NB) * G))

    i_io = torch.arange(SS, device=dev).view(1, SS, 1)
    g_io = torch.arange(NG, device=dev).view(1, 1, NG)
    key = ((si.view(-1, 1, 1) * SS + i_io) << 13) | (sj.view(-1, 1, 1) * NG
                                                     + g_io)
    wflat = words.view(-1, NW)
    live = (wflat != 0).any(1)
    run_cap = max(min(S_cap * W, 16384), S_cap * W // 4)
    run_cap = min(run_cap, live.shape[0])
    nruns = live.sum()
    overflow = nruns > run_cap
    # dead runs take the sentinel key and sort last; live keys are unique
    key_s, perm = torch.sort(torch.where(live, key.reshape(-1), _SENTINEL))
    key_i = key_s[:run_cap]
    words_s = wflat[perm[:run_cap]]
    ti_r = (key_i >> 13) & 0xFFFF
    run_r = key_i & 0x1FFF
    rvalid = torch.arange(run_cap, device=dev) < nruns
    a_idx, grouped, nsteps = leader_group(
        ti_r, rvalid, (run_r, *words_s.unbind(1)), (pad_run,) + (0,) * NW,
        W, S_cap)
    bm_words = torch.stack(grouped[1:])
    overflow |= nsteps > S_cap
    return a_idx, grouped[0], bm_words, nsteps, num_checks, overflow


def _fold_sub4(sub):
    """Fold ``(6, T, NB)`` sub-band bounds to the fallback's 4 bands (its
    pair payload carries 4 band bits)."""
    NB = sub.shape[2]
    if NB == 4:
        return sub
    g = sub.view(6, sub.shape[1], 4, NB // 4)
    return torch.cat([g[:3].amin(3), g[3:].amax(3)])


def _phase1_tile_pairs(tiles, sub, P_cap: int, tiles_b=None):
    """Superpairs -> band bits of 4 folded bands -> compacted pair list.
    With ``tiles_b`` (the JAX package's ``_phase1_cross_pairs``): the
    overlapping (tile of bvh1, tile of bvh2) pairs of the full grid.

    Returns ``(packed, band, npairs)``: (P_cap,) int32 pairs ``ti << 16 |
    tj`` (int32 wrap-around; ti <= tj on one tile set), their (P_cap,)
    int32 band masks, and the 0-dim int32 pair count (``P_cap + 1`` on any
    phase-1 overflow)."""
    si, sj, nsp, sp_overflow = _phase1_superpairs(tiles, P_cap, tiles_b)
    bits = subtile_band_bits(
        _fold_sub4(sub), tiles if tiles_b is None else tiles_b, si, sj,
        nsp.clamp(max=si.shape[0]).reshape(1), triangle=tiles_b is None)
    SP_cap = si.shape[0]
    # superpair axis minor: every mega-tile of the compactor mixes all
    # superpairs, so its survivor density stays near the mean
    bits_t = bits.permute(1, 2, 0).contiguous()          # (SS, SS, SP_cap)
    k = torch.arange(SS, dtype=torch.int32, device=bits.device)
    tii = (si * SS + k[:, None, None]).expand(SS, SS, SP_cap)
    tjj = (sj * SS + k[None, :, None]) | (bits_t << 16)
    cap_c = max(2048, P_cap // 116)
    (out_ti, out_tjb), npairs, c_overflow = compact_flat(
        (bits_t > 0).reshape(-1), (tii.reshape(-1), tjj.reshape(-1)),
        cap=cap_c, row_cap=128, capacity=P_cap)
    p64 = (out_ti.long() << 16) | (out_tjb & 0xFFFF).long()
    packed = _wrap_int32(p64)
    npairs = torch.where(sp_overflow | c_overflow, P_cap + 1, npairs)
    return packed, out_tjb >> 16, npairs


def _group_pairs(packed, band, npairs, W: int, S_cap: int, T_pad: int):
    """Sort a packed pair list by (ti, tj) and pack each a-tile's b-tiles W
    per step.  Returns ``(a_idx (S_cap,), b_idx (S_cap*W,), nsteps)``;
    entries ``tj | band << 16``, pads ``T_pad`` with band 0."""
    valid = torch.arange(packed.shape[0], device=packed.device) < npairs
    # the JAX package sorts the packed words as uint32: an int64 key keeps
    # ti >= 32768 in order, and the 2^32 sentinel sorts the pads last
    key = torch.where(valid, packed.long() & 0xFFFFFFFF, 1 << 32)
    key, perm = torch.sort(key)
    b_entry = (key & 0xFFFF) | (band[perm].long() << 16)
    a_idx, (b_idx,), nsteps = leader_group(
        (key >> 16) & 0xFFFF, valid, (b_entry,), (T_pad,), W, S_cap)
    return a_idx, b_idx, nsteps


def _regroup_emit_runs(a_idx, run_idx, bm_words, counts, colmax, W2: int,
                       S2_cap: int, E2_cap: int, T_pad: int, R: int,
                       NB: int = 4, decode_k: int = 0, D_cap: int = 0):
    """Regroup the tile pairs with contacts for the emit kernel (payload
    ``tj | band << 16 | cnt << 20 | okc << 28``).  Returns ``(a_idx2,
    b_idx2, nsteps2, over2)``; ``over2``: more live runs than E2_cap.

    With ``decode_k > 0`` the pairs that :func:`_moment_decode` can finish
    (every column at most 2 contacts, at most ``decode_k`` contacts) leave
    the emit grouping, up to ``D_cap`` of them (the rest stay with the
    emit kernel), and a fifth value is returned: ``(dec_pk, dec_flat,
    dec_cnt, ndec)``, (D_cap,) int32 arrays of the pairs ``ti << 16 | tj``,
    their rows in the count kernel's word plane and their counts, and the
    number of them."""
    SW = run_idx.shape[0]
    Win = SW // a_idx.shape[0]
    dev = counts.device
    rc = counts.view(SW, R)
    run_live = rc.amax(1) > 0
    nlive = run_live.sum()
    E2c = min(E2_cap, SW)
    over2 = nlive > E2c
    slot = torch.arange(SW, device=dev)
    slot_r = torch.sort(torch.where(run_live, slot, _SENTINEL)).values[:E2c]
    slot_c = torch.where(slot_r == _SENTINEL, 0, slot_r)
    ti_r = a_idx[slot_c // Win]
    base_r = run_idx[slot_c] & 0xFFFF
    rc_r = rc[slot_c].clamp(max=255)                     # 8-bit payload field
    ok_r = (colmax.view(SW, R)[slot_c] <= 2).int()
    E = E2c * R
    el = torch.arange(E, device=dev)
    t = el % R
    TPW = 32 // NB
    wsel = bm_words[:, slot_c].repeat_interleave(R, 1)[t // TPW, el]
    bits_nb = (wsel >> (NB * (t % TPW))) & ((1 << NB) - 1)
    gsz = NB // 4        # fold NB fine bands to the emit kernel's 4
    band4 = torch.zeros_like(bits_nb)
    for c in range(4):
        live_c = ((bits_nb >> (c * gsz)) & ((1 << gsz) - 1)) != 0
        band4 |= live_c.long() << c
    tj = base_r.repeat_interleave(R) * R + t
    cnt = rc_r.reshape(-1)
    valid = (cnt > 0) & (el < nlive * R)
    tj_c = torch.where(valid, tj, T_pad)
    okbit = ok_r.reshape(-1)
    ti_flat = ti_r.repeat_interleave(R)
    emit_valid = valid
    if decode_k:
        if not 0 < D_cap <= 1 << 17:
            raise ValueError(f"D_cap must be in (0, 2^17], got {D_cap}")
        is_dec = valid & (okbit == 1) & (cnt <= decode_k)
        dm = is_dec.int()
        dpos = torch.cumsum(dm, 0) - dm
        is_dec &= dpos < D_cap
        emit_valid = valid & ~is_dec
        ddst = torch.where(is_dec, dpos, D_cap)
        # row of entry (slot, t) in the word plane: the sort key is the
        # original (step * W + w) slot of a live run
        flat = slot_r.repeat_interleave(R) * R + t
        dec_pk = scatter_drop(
            D_cap, ddst, _wrap_int32((ti_flat.long() << 16) | tj_c), 0)
        dec_flat = scatter_drop(D_cap, ddst, flat.int(), 0)
        dec_cnt = scatter_drop(D_cap, ddst, cnt, 0)
        ndec = dm.sum(dtype=torch.int32).clamp(max=D_cap)
    payload = tj_c | (band4 << 16) | (cnt << 20) | (okbit << 28)
    a_idx2, (b_idx2,), nsteps2 = leader_group(
        ti_flat, emit_valid, (payload,), (T_pad,), W2, S2_cap)
    if decode_k:
        return a_idx2, b_idx2, nsteps2, over2, (dec_pk, dec_flat, dec_cnt,
                                                ndec)
    return a_idx2, b_idx2, nsteps2, over2


def _moment_decode(words, dec_pk, dec_flat, dec_cnt, ndec, G: int, K: int,
                   capacity: int):
    """Contacts of the moment-captured pairs from the count kernel's word
    plane, with no emit kernel: a pair whose every column holds at most 2
    contacts and which has at most K contacts (so at most K live columns)
    is read back from its row of column words ``cc << 23 | is << 15 | iq``
    (``is`` the sum of the hit rows, ``iq`` of their squares).  Live
    columns carry a word >= 2^23 and dead ones 0, so ``topk(K)`` of the row
    finds exactly the live columns; a column's rows are ``is`` (cc = 1) or
    ``(is -+ sqrt(2 iq - is^2)) / 2`` (cc = 2; the root is of a perfect
    square below 2^15, exact in float32).

    ``words`` is the (S_flat, 128) int32 plane, ``dec_*`` the (D_cap,)
    arrays of :func:`_regroup_emit_runs`.  Returns ``(gi, gj, total)``: a
    dense (capacity,) int32 stream of sorted positions, pairs in ``dec``
    order; the order of the contacts inside a pair follows ``topk`` and is
    not fixed.  The stream is one scatter of packed words ``e << 14 |
    i << 7 | col`` (hence D_cap <= 2^17 and G <= 128) and one gather of
    ``dec_pk``."""
    D_cap = dec_pk.shape[0]
    if D_cap > 1 << 17 or G > 128:
        raise ValueError(f"need D_cap <= 2^17 and G <= 128, got {D_cap}, {G}")
    dev = words.device
    rows = words[dec_flat.clamp(0, words.shape[0] - 1).long()]  # (D_cap, 128)
    vals, cols = torch.topk(rows, K, dim=1)
    cols = cols.int()
    e = torch.arange(D_cap, dtype=torch.int32, device=dev)[:, None]
    cc = torch.where(e < ndec, (vals >> 23) & 0xFF, 0)
    isv = (vals >> 15) & 0xFF
    iq = vals & 0x7FFF
    dv = torch.sqrt((2 * iq - isv * isv).clamp(min=0).float()).int()
    one = cc >= 1
    two = cc == 2
    i1 = torch.where(two, (isv - dv) >> 1, isv)
    i2 = (isv + dv) >> 1
    e_id = e << 14
    p1 = e_id | (i1 << 7) | cols
    p2 = e_id | (i2 << 7) | cols
    nk = torch.where(one, cc, 0)
    exc = torch.cumsum(nk, 1, dtype=torch.int32) - nk        # within a pair
    incl = torch.cumsum(dec_cnt, 0, dtype=torch.int32)
    offs = (incl - dec_cnt)[:, None]                         # pair offsets
    total = incl[-1]
    d1 = torch.where(one, offs + exc, capacity)
    d2 = torch.where(two, offs + exc + 1, capacity)
    stream = scatter_drop(capacity, torch.cat([d1, d2], 1).reshape(-1),
                          torch.cat([p1, p2], 1).reshape(-1), 0)
    spk = dec_pk[(stream >> 14).clamp(0, D_cap - 1).long()]
    gi = ((spk >> 16) & 0xFFFF) * G + ((stream >> 7) & 0x7F)
    gj = (spk & 0xFFFF) * G + (stream & 0x7F)
    return gi, gj, total


def _finish_contacts(q, out_gi, out_gj, total):
    """Map a dense stream of global sorted positions to the query's final
    user-index contact list, with its optional ``narrow`` filter
    (re-compacted): sorted ``(min, max)`` pairs for self-contact, else
    ``(leaf_index[gi], leaf_index_b[gj])`` as they come (rays: leaf and
    1-based ray index).  Returns ``(total, contacts (capacity, 2))``."""
    leaf_index, leaf_index_b, capacity = q.leaf_index, q.leaf_index_b, \
        q.capacity
    lane = torch.arange(capacity, device=leaf_index.device)
    out_gi = out_gi.clamp(0, leaf_index.shape[0] - 1).long()
    out_gj = out_gj.clamp(0, leaf_index_b.shape[0] - 1).long()
    ui, uj = leaf_index[out_gi], leaf_index_b[out_gj]
    in_range = lane < total
    if q.narrow_fn is not None:
        keep = in_range & q.narrow_fn(out_gi, out_gj)
        ui, total = _cumsum_compact(keep, ui, capacity)
        uj, _ = _cumsum_compact(keep, uj, capacity)
        in_range = lane < total
    if q.dedup:
        ui, uj = torch.minimum(ui, uj), torch.maximum(ui, uj)
    a = torch.where(in_range, ui, 0)
    b = torch.where(in_range, uj, 0)
    return total, torch.stack([a, b], dim=-1)


def _merge_streams(parts, capacity: int):
    """Concatenate per-part dense streams ``(gi, gj, total)`` into one
    (capacity,) stream and its grand total (one part passes through)."""
    if len(parts) == 1:
        gi, gj, tot = parts[0]
        return gi.int(), gj.int(), tot
    C = parts[0][0].shape[0]
    gis = torch.cat([p[0] for p in parts])
    gjs = torch.cat([p[1] for p in parts])
    k = torch.arange(capacity, device=gis.device)
    flat = k
    total = torch.zeros((), dtype=torch.int32, device=gis.device)
    for c, p in enumerate(parts):
        if c:
            flat = torch.where(k >= total, c * C + (k - total), flat)
        total = total + p[2]
    flat = flat.clamp(0, gis.shape[0] - 1)
    in_range = k < total
    return (torch.where(in_range, gis[flat].int(), 0),
            torch.where(in_range, gjs[flat].int(), 0), total)


def _two_phase(alg: TileTraversal, capacity: int) -> bool:
    """The route rule: the two-phase route for ``pair_cap <= 128`` and a
    capacity of whole 1024-contact quanta, the fallback otherwise."""
    return alg.pair_cap <= 128 and capacity % 1024 == 0


@dataclasses.dataclass(frozen=True, eq=False)
class _TileQuery:
    """One query as the route back ends see it, filled by its front end.
    ``fsets``: the a set's fields, then the b set's unless the query is
    self-contact (one set: the j > i triangle, sorted pairs); rays are
    the a set.  The finish maps a positions by ``leaf_index``, b positions
    by ``leaf_index_b``, the b position first with ``swap`` (a ray hit's
    leaf).  ``stage`` and ``tag`` name the stage spans and their
    attributes; ``tiles``, ``sub``, ``tiles2`` and ``pair_capacity`` are
    phase 1's (self and two trees only)."""

    fsets: tuple
    mask_kind: str
    alg: TileTraversal
    capacity: int
    leaf_index: torch.Tensor
    leaf_index_b: torch.Tensor
    narrow_fn: Optional[Callable] = None
    swap: bool = False
    stage: str = "tiles"
    tag: dict = dataclasses.field(default_factory=dict)
    tiles: Optional[torch.Tensor] = None
    sub: Optional[torch.Tensor] = None
    tiles2: Optional[torch.Tensor] = None
    pair_capacity: int = 0

    def __post_init__(self):
        if max(f.shape[1] for f in self.fsets) >= 1 << 16:
            raise ValueError("tile count exceeds 65536; raise the tile size")

    @property
    def dedup(self) -> bool:
        return len(self.fsets) == 1

    @property
    def T_a(self) -> int:
        return self.fsets[0].shape[1]

    @property
    def T_b(self) -> int:
        return self.fsets[-1].shape[1]

    def span(self, step: str):
        return tracing.span(f"{self.stage}.{step}", self.fsets[0].device,
                            **self.tag)


def _tile_query(bvh1: BVH, bvh2: Optional[BVH], capacity: int,
                alg: Optional[TileTraversal], pair_capacity: Optional[int],
                narrow) -> _TileQuery:
    """The setup of a self (``bvh2`` None) or two-tree query, single-device
    or sharded: the leaf-kind check, the field sets (a ``tiles.fields``
    span), the default pair capacity, the ``narrow`` filter and the
    finish's index maps."""
    alg = alg or TileTraversal()
    pair = bvh2 is not None
    if pair and bvh1.leaf_kind is not bvh2.leaf_kind:
        raise NotImplementedError(
            "tile pair traversal needs leaves of one kind in both BVHs; "
            "LVTTraversal() takes mixed kinds")
    with tracing.span("tiles.fields", bvh1.device, bodies=1 + pair):
        f1, sphere, tiles1, sub1, T1 = _tiled_fields(bvh1, alg.tile,
                                                     alg.bands)
        fsets, tiles2, T2 = (f1,), None, T1
        if pair:
            # a float32 tree against a float64 one is widened to float64
            # before any kernel: exact, and what the JAX package's
            # promotion inside its kernels amounts to
            f2, _, tiles2, _, T2 = _tiled_fields(bvh2, alg.tile)
            dt = torch.promote_types(f1.dtype, f2.dtype)
            f1, tiles1, sub1, f2, tiles2 = (
                t.to(dt) for t in (f1, tiles1, sub1, f2, tiles2))
            fsets = (f1, f2)
    leaves2 = bvh2.leaves if pair else bvh1.leaves
    if pair_capacity is None:
        pair_capacity = _pair_capacity_for((T1 + T2) // 2)
    narrow_fn = None
    if narrow is not None:
        leaves1 = bvh1.leaves

        def narrow_fn(gi, gj):
            return narrow(leaves1[gi], leaves2[gj])

    return _TileQuery(
        fsets, "sphere" if sphere else "box", alg, capacity,
        bvh1.leaves.index, leaves2.index, narrow_fn,
        tag={"pair": True} if pair else {}, tiles=tiles1, sub=sub1,
        tiles2=tiles2, pair_capacity=pair_capacity)


def _two_phase_route(q: _TileQuery, a_idx, run_idx, bm_words, nsteps,
                     run_overflow, S2_cap: int, E2_cap: int, D_want: int,
                     decode_k: int):
    """The two-phase back end on a front end's run lists: the count kernel,
    regroup, moment decode (``decode_k > 0``; ``D_cap`` from ``D_want``),
    the emit kernel (step cap ``S2_cap``, at most ``E2_cap`` live runs),
    merge and finish.  Returns ``(total, contacts (capacity, 2),
    cap_overflow, slot_overflow)``: ``cap_overflow`` is ``run_overflow``
    or a list or the stream past its cap (the total past ``capacity`` is
    left to the caller), ``slot_overflow`` a pair or a row past its cap."""
    alg, fsets, capacity = q.alg, q.fsets, q.capacity
    R, NB, DK, dedup = alg.run_r, alg.bands, decode_k, q.dedup
    with q.span("count"):
        counts, colmax, *words = tile_run_counts(
            a_idx, run_idx, bm_words, nsteps.reshape(1), *fsets,
            mask_kind=q.mask_kind, R=R, NB=NB, dedup=dedup,
            moments=bool(DK))
        slot_overflow = (counts > alg.pair_cap).any()

    D_cap = min(max(8192, D_want), E2_cap * R, 1 << 17) if DK else 0
    with q.span("regroup"):
        a_idx2, b_idx2, nsteps2, over2, *dec = _regroup_emit_runs(
            a_idx, run_idx, bm_words, counts, colmax, alg.emit_w, S2_cap,
            E2_cap, q.T_b, R, NB, decode_k=DK, D_cap=D_cap)
    with q.span("emit"):
        parts = [_moment_decode(words[0], *dec[0], fsets[0].shape[2], DK,
                                capacity)] if DK else []
        gi, gj, tot, flags = tile_group_emit(
            a_idx2, b_idx2, nsteps2.reshape(1), *fsets,
            mask_kind=q.mask_kind, ROW_CAP=alg.row_cap,
            CAP_PAIR=alg.pair_cap, dedup=dedup, CAP=capacity)
    cap_overflow = run_overflow | (nsteps2 > S2_cap) | over2 | \
        ((flags & 1) > 0)
    slot_overflow = slot_overflow | ((flags & 2) > 0)
    with q.span("merge"):
        gi, gj, total = _merge_streams(parts + [(gi, gj, tot)], capacity)
    with q.span("finish"):
        if q.swap:
            gi, gj = gj, gi
        total, contacts = _finish_contacts(q, gi, gj, total)
    return total, contacts, cap_overflow, slot_overflow


def _fallback_route(q: _TileQuery, a_idx, b_idx, nsteps):
    """The fallback's back end on a front end's W-grouped pair lists: the
    slot kernel writes each pair's padded slots; pair ``p`` owns output
    slots ``[off[p], off[p] + counts[p])``, ``off`` the exclusive prefix of
    the uncapped counts (whose sum is the total), and each output slot
    finds its pair by a binary search and gathers its lane.  Returns
    ``(total, contacts (capacity, 2), slot_overflow)``."""
    alg = q.alg
    with q.span("emit"):
        gi, gj, counts, slot_overflow = tile_group_contacts(
            a_idx, b_idx, nsteps.reshape(1), *q.fsets,
            mask_kind=q.mask_kind, ROW_CAP=alg.row_cap,
            CAP_PAIR=alg.pair_cap, dedup=q.dedup)
    with q.span("finish"):
        SW, CAP_PAIR = gi.shape
        incl = torch.cumsum(counts, 0, dtype=torch.int32)
        k = torch.arange(q.capacity, dtype=torch.int32, device=gi.device)
        p = torch.searchsorted(incl, k, right=True).clamp(max=SW - 1)
        lane = (k - (incl[p] - counts[p])).clamp(0, CAP_PAIR - 1)
        flat = p * CAP_PAIR + lane
        if q.swap:
            gi, gj = gj, gi
        total, contacts = _finish_contacts(q, gi.view(-1)[flat],
                                           gj.view(-1)[flat], incl[-1])
    return total, contacts, slot_overflow


def _tiles_fixed(bvh1: BVH, bvh2: Optional[BVH], capacity: int,
                 alg: Optional[TileTraversal], pair_capacity: Optional[int],
                 narrow):
    """The fixed-capacity tile traversal of ``bvh1`` with itself (``bvh2``
    None: the j > i triangle, sorted pairs) or against ``bvh2`` (the full
    grid, tree-order pairs).  The a side (rows, sub-bands, steps) is bvh1,
    the b side (runs, columns, pads) bvh2."""
    q = _tile_query(bvh1, bvh2, capacity, alg, pair_capacity, narrow)
    alg, T1, P_cap = q.alg, q.T_a, q.pair_capacity
    G, W = alg.tile, alg.count_w
    if not _two_phase(alg, capacity):   # the pair-granularity fallback
        with q.span("phase1"):
            packed, band, npairs = _phase1_tile_pairs(q.tiles, q.sub, P_cap,
                                                      q.tiles2)
            S_cap, _ = _step_caps(P_cap // W + T1)
            a_idx, b_idx, nsteps = _group_pairs(packed, band, npairs, W,
                                                S_cap, q.T_b)
        pair_overflow = (npairs > P_cap) | (nsteps > S_cap)
        total, contacts, slot_overflow = _fallback_route(q, a_idx, b_idx,
                                                         nsteps)
        overflow = ((pair_overflow | (total > capacity)).int()
                    | (slot_overflow.int() << 1))
        lane = torch.arange(band.shape[0], device=band.device)
        num_checks = (torch.where(lane < npairs, _popcount(band), 0).sum()
                      .to(torch.float32) * float((G // N_BANDS) * G))
        return total, contacts, overflow, num_checks
    S_cap = _run_step_cap(P_cap // W + T1, alg)
    with q.span("phase1"):
        si, sj, nsp, sp_overflow = _phase1_superpairs(q.tiles, P_cap,
                                                      q.tiles2)
    total, contacts, cap_overflow, slot_overflow, num_checks = \
        _two_phase_slice(
            q, si, sj, nsp.clamp(max=si.shape[0]), S_cap,
            _step_caps(T1 + capacity // (8 * alg.emit_w))[0],
            max(4096, capacity // 8), D_want=capacity // 8,
            decode_k=alg.decode_k if q.dedup else 0)
    overflow = ((sp_overflow | cap_overflow | (total > capacity)).int()
                | (slot_overflow.int() << 1))
    return total, contacts, overflow, num_checks


def _run_step_cap(need: int, alg: TileTraversal) -> int:
    """The count kernel's step cap for ``need`` steps (the JAX package's
    ``S_cap``), rounded up to its run-chunk cap when a chunk would pass
    it."""
    S_cap, chunk = _step_caps(need)
    ch_cap = _run_chunk_cap(alg.count_w, alg.run_r, alg.bands)
    if chunk > ch_cap:
        S_cap = -(-S_cap // ch_cap) * ch_cap
    return S_cap


def _two_phase_slice(q: _TileQuery, si, sj, nsp, S_cap: int, S2_cap: int,
                     E2_cap: int, D_want: int, decode_k: int):
    """The two-phase route of a self or two-tree query on a superpair
    slice ``(si, sj, nsp)`` (all of it on one device, a rank's share when
    sharded): :func:`_slice_runs` with the step cap ``S_cap``, then
    :func:`_two_phase_route`.  Returns its four values and
    ``num_checks``."""
    alg, R = q.alg, q.alg.run_r
    with q.span("phase1"):
        a_idx, run_idx, bm_words, nsteps, num_checks, run_overflow = \
            _slice_runs(q.sub, q.tiles if q.dedup else q.tiles2, si, sj, nsp,
                        alg.tile, alg.count_w, S_cap, R, -(-q.T_b // R),
                        alg.bands, triangle=q.dedup)
    return (*_two_phase_route(q, a_idx, run_idx, bm_words, nsteps,
                              run_overflow, S2_cap, E2_cap, D_want,
                              decode_k), num_checks)


def traverse_tiles_fixed(bvh: BVH, capacity: int, *,
                         alg: Optional[TileTraversal] = None,
                         pair_capacity: Optional[int] = None, narrow=None):
    """Fixed-capacity tile self-contact traversal, with no host sync.

    Returns ``(total, contacts, overflow, num_checks)`` as tensors on the
    BVH's device: the contact count, a ``(capacity, 2)`` int32 list of
    sorted 1-based ``(min, max)`` user-index pairs, the overflow bitmask
    (bit 0: a buffer capacity, bit 1: a slot cap; results are incomplete
    when it is set) and the number of leaf tests of live bands.
    """
    return _tiles_fixed(bvh, None, capacity, alg, pair_capacity, narrow)


def traverse_tiles_pair_fixed(bvh1: BVH, bvh2: BVH, capacity: int, *,
                              alg: Optional[TileTraversal] = None,
                              pair_capacity: Optional[int] = None,
                              narrow=None):
    """Fixed-capacity tile traversal of two BVHs, with no host sync.

    Returns ``(total, contacts, overflow, num_checks)`` as
    :func:`traverse_tiles_fixed` does; the contacts are tree-order
    ``(index in bvh1, index in bvh2)`` pairs, ``(i, i)`` and symmetric
    pairs included, in the order the route emits them.  Both BVHs must
    have leaves of one kind.  ``bvh1`` is tiled with ``alg.bands``
    sub-bands, ``bvh2`` needs none; ``alg.decode_k`` is not read.
    """
    tracing.count("calls.tiles_pair")
    return _tiles_fixed(bvh1, bvh2, capacity, alg, pair_capacity, narrow)


def _grow_tiles(run_fixed, walk, alg, capacity: int, pair_capacity: int,
                cache, options: BVHOptions, skips: torch.Tensor,
                **levels) -> BVHTraversal:
    """Overflow-driven growth around a fixed-capacity tile traversal:
    ``run_fixed(capacity, alg, pair_capacity)`` is re-run with grown
    capacities (overflow bit 0) or slot caps (bit 1) until nothing
    overflows; ``cache`` (a previous result) gives the starting capacities.
    A scene still overflowing after eight runs is too dense for the slot
    caps (one tile pair with more than ``MAX_PAIR_CAP`` contacts) and takes
    ``walk()``, the leaf-vs-tree walk, which handles any density.  The
    empty ``cache2`` takes the index dtype of ``skips``.  Each run is a
    ``traverse.run`` span and the walk a ``traverse.walk`` span; the
    ``grow.*`` counters count them (see ``tracing``)."""
    if cache is not None and cache.cache1.dim() == 2 \
            and cache.cache1.shape[0] > 0:
        capacity = cache.cache1.shape[0]
    if cache is not None and cache.pair_capacity > 0:
        pair_capacity = cache.pair_capacity
    if cache is None or cache.tile_alg is None or cache.pair_capacity <= 0:
        tracing.count("grow.cold")
    dev = skips.device
    for run in range(8):
        tracing.count("grow.runs")
        with tracing.span("traverse.run", dev) as s:
            if s:
                s.set(run=run, capacity=capacity,
                      pair_capacity=pair_capacity, row_cap=alg.row_cap,
                      pair_cap=alg.pair_cap)
            total, contacts, overflow, num_checks = run_fixed(
                capacity, alg, pair_capacity)
            ov = tracing.to_int(overflow, "tiles.overflow")
            if s:
                s.set(overflow=ov)
        if ov == 0:
            return BVHTraversal(
                num_contacts=tracing.to_int(total, "tiles.total"),
                cache1=contacts, cache2=skips.new_zeros((0,)),
                num_checks=tracing.to_int(num_checks, "tiles.checks"),
                pair_capacity=pair_capacity, tile_alg=alg, **levels)
        if ov & 1:
            tracing.count("grow.capacity")
            capacity = _grow_capacity(capacity, options.capacity_growth)
            pair_capacity = _grow_capacity(
                pair_capacity, options.capacity_growth, 8192)
        if ov & 2:
            tracing.count("grow.slots")
            alg = _grow_alg(alg)
    tracing.count("grow.walks")
    with tracing.span("traverse.walk", dev):
        return walk()


def _pow2_capacity(need: int, options: BVHOptions) -> int:
    return 1 << math.ceil(math.log2(max(options.min_capacity, need)))


def traverse_tiles(bvh: BVH, *, alg: Optional[TileTraversal] = None,
                   narrow=None, cache: Optional[BVHTraversal] = None,
                   options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Tile self-contact with overflow-driven growth (:func:`_grow_tiles`
    around :func:`traverse_tiles_fixed`), ending in
    ``traverse(bvh, LVTTraversal())`` for a scene past the slot caps'
    ceilings."""
    from .api import _traverse
    alg = _merge_cached_alg(alg or TileTraversal(), cache)
    if bvh.tree.real_nodes <= 1:
        return _empty_traversal(bvh, 1)
    return _grow_tiles(
        lambda c, a, pc: traverse_tiles_fixed(bvh, c, alg=a,
                                              pair_capacity=pc,
                                              narrow=narrow),
        lambda: _traverse(bvh, LVTTraversal(), narrow=narrow,
                          options=options),
        alg, _pow2_capacity(bvh.num_leaves, options),
        _pair_capacity_for(-(-bvh.num_leaves // alg.tile)), cache, options,
        bvh.skips)


def traverse_tiles_pair(bvh1: BVH, bvh2: BVH, *,
                        alg: Optional[TileTraversal] = None, narrow=None,
                        cache: Optional[BVHTraversal] = None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Tile traversal of two BVHs with overflow-driven growth
    (:func:`_grow_tiles` around :func:`traverse_tiles_pair_fixed`), from a
    capacity of twice the larger leaf count, ending in
    ``traverse(bvh1, bvh2, LVTTraversal())``."""
    from .api import _traverse
    tracing.count("calls.tiles_pair")
    alg = _merge_cached_alg(alg or TileTraversal(), cache)
    T = -(-bvh1.num_leaves // alg.tile) + -(-bvh2.num_leaves // alg.tile)
    return _grow_tiles(
        lambda c, a, pc: _tiles_fixed(bvh1, bvh2, c, a, pc, narrow),
        lambda: _traverse(bvh1, bvh2, LVTTraversal(), narrow=narrow,
                          options=options),
        alg, _pow2_capacity(2 * max(bvh1.num_leaves, bvh2.num_leaves),
                            options),
        _pair_capacity_for(T // 2), cache, options, bvh1.skips,
        start_level2=1)
