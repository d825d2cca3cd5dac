"""Tile ray traversal: batch ray queries through the tile engine.

Counterpart of ``implicitbvh_tpu/traverse/ray_tiles.py``, with the scheme of
tile self-contact (``traverse/tiles.py``):

1. Rays are sorted for coherence by (direction bin, Morton code of the
   origin), direction bin = sign octant x dominant axis, and grouped into
   ray tiles of G.
2. Phase 1 (R1, ``ops/subtile.py:ray_band_bits``): a slab test of every
   ray against every leaf tile's AABB, any-reduced over each ray tile's NB
   sub-bands of G/NB rays, gives the (ray tile, leaf tile) band bits.
3. One of two routes, chosen as in the JAX package:

   - **two-phase** (``pair_cap <= 128`` and ``capacity % 1024 == 0``): the
     candidate leaf tiles of a ray tile form aligned runs of R, which
     ``tiles._two_phase_route`` takes (ray mask, rays as the a set and
     leaves as the b set): the count kernel counts each pair's hits and,
     with ``decode_k``, writes the per-column moment words; pairs with few
     hits are decoded from those words, the others go through the emit
     kernel;
   - **pair-granularity fallback** (otherwise): the candidate leaf tiles
     are packed W per step for ``tiles._fallback_route``, whose slot
     kernel writes each pair's padded hit slots.

4. Sorted positions become ``(leaf user index, 1-based ray index)`` pairs.
   Their order in the list is not part of the contract: only the set is.

The hit set is that of ``volumes.isintersection`` of every ray against every
leaf.  The capacity arithmetic is the JAX package's, copied so that the
overflow bits and growth agree.  The fixed path makes no host sync.  Growth
past the slot caps' ceilings ends in the leaf-vs-tree ray walk
(``raytrace.traverse_rays`` with ``LVTTraversal()``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing
from ..build import BVH
from ..morton import DefaultMortonAlgorithm, morton_encode
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..ops.grouping import scatter_drop
from ..ops.subtile import ray_band_bits
from ..ops.tile_contact import N_BANDS
# not called here: portbench's harness patches this name beside tiles'
from ..ops.tile_contact import tile_run_counts  # noqa: F401
from .tiles import (RAY_CANDS_PER_RAY_TILE, TileTraversal, _TileQuery,
                    _fallback_route, _grow_tiles, _merge_cached_alg,
                    _popcount, _pow2_capacity, _run_step_cap, _step_caps,
                    _tiled_fields, _two_phase, _two_phase_route,
                    _wrap_int32)
from .lvt import _empty_traversal
from .types import BVHTraversal, LVTTraversal

# rays want a deeper per-ray slot cap than self-contact: one ray can pass
# through several leaves of one tile (a row is a ray)
RAY_ALG = TileTraversal(row_cap=8, emit_w=8, decode_k=8)


def _ray_pair_capacity(RT: int) -> int:
    return max(((RT * RAY_CANDS_PER_RAY_TILE + 8191) // 8192) * 8192, 8192)


def _sort_rays(p, d):
    """Coherence sort: the permutation ordering rays by (direction bin,
    Morton code of the origin), ties in input order.  Direction bin = sign
    octant (3 bits) x dominant axis (0..2)."""
    octant = (d[0] < 0).long() * 4 + (d[1] < 0).long() * 2 + (d[2] < 0).long()
    a0, a1, a2 = d[0].abs(), d[1].abs(), d[2].abs()
    ax = torch.where(a0 >= a1, torch.where(a0 >= a2, 0, 2),
                     torch.where(a1 >= a2, 1, 2))
    dbin = octant * 3 + ax
    code = morton_encode(p, DefaultMortonAlgorithm(bits=32))
    return torch.sort((dbin << 32) | code, stable=True).indices


def _ray_tile_fields(p, d, perm, G: int):
    """Permute the rays and tile them into (6, RT, G) fields (p0, p1, p2,
    d0, d1, d2), NaN padded: every comparison against a padded ray is
    false.  Returns ``(fields, RT)``."""
    n = perm.shape[0]
    RT = -(-n // G)
    raw = torch.stack([*p, *d])[:, perm]
    fields = torch.nn.functional.pad(raw, (0, RT * G - n),
                                     value=float("nan"))
    return fields.view(6, RT, G), RT


def _ray_tile_hits(rfields, tiles, NB: int = 4):
    """(RT, T) int32 band bits: bit r is set iff a ray of sub-band r (G/NB
    rays) of ray tile rt hits the AABB of leaf tile t (``tiles``: (6, T)
    bounds).  One launch of R1 on the card, its plain version on the
    CPU."""
    return ray_band_bits(rfields, tiles, NB)


def _group_positions(live, W: int):
    """Row-major packing of the live entries of an (RT, N) mask, W per
    step, a ray tile's entries in steps of their own.  Returns ``(step,
    lane, nsteps)``: each entry's step and lane in it, and the step
    count."""
    h = live.int()
    q = torch.cumsum(h, 1) - h                       # position in the row
    gcnt = (q[:, -1] + h[:, -1] + W - 1) // W        # steps of a ray tile
    goff = torch.cumsum(gcnt, 0) - gcnt
    return goff[:, None] + q // W, q % W, gcnt.sum().int()


def _phase1_ray_runs(rfields, tiles, W: int, S_cap: int, R: int,
                     pad_run: int, NB: int = 4):
    """Candidate extraction of the two-phase ray route: each ray tile's
    candidate aligned runs of R leaf tiles, W per step, with NB band bits
    per leaf tile packed into R*NB/32 int32 words per run: the inputs of
    ``tile_run_counts``.  The (RT, T) bit matrix is dense and row-major, so
    no sort is needed.

    Returns ``(a_idx, run_idx, bm_words (NW, S_cap*W), nsteps,
    num_checks, overflow)``, ``overflow`` the steps past ``S_cap``."""
    bits = _ray_tile_hits(rfields, tiles, NB)
    RT, T = bits.shape
    G = rfields.shape[2]
    TPW = 32 // NB
    NW = R // TPW
    NGT = -(-T // R)
    bits = torch.nn.functional.pad(bits, (0, NGT * R - T))
    shifts = NB * torch.arange(TPW, device=bits.device)
    words = _wrap_int32(
        (bits.view(RT, NGT, NW, TPW).long() << shifts).sum(-1))
    # float32, as in the JAX package: the product passes 2^31 at 100k rays
    num_checks = (_popcount(words).sum().to(torch.float32)
                  * float((G // NB) * G))
    live = (words != 0).any(-1)                              # (RT, NGT)
    step, lane, nsteps = _group_positions(live, W)
    dst = torch.where(live, step * W + lane, S_cap * W).reshape(-1)
    g_idx = torch.arange(NGT, dtype=torch.int32, device=bits.device)
    run_idx = scatter_drop(S_cap * W, dst,
                           g_idx.expand(RT, NGT).reshape(-1), pad_run)
    bm_words = torch.stack([
        scatter_drop(S_cap * W, dst, words[..., q].reshape(-1), 0)
        for q in range(NW)])
    rt_idx = torch.arange(RT, dtype=torch.int32, device=bits.device)
    a_idx = scatter_drop(S_cap, torch.where(live, step, S_cap).reshape(-1),
                         rt_idx[:, None].expand(RT, NGT).reshape(-1), 0)
    return a_idx, run_idx, bm_words, nsteps, num_checks, nsteps > S_cap


def _phase1_ray_tile_groups(rfields, tiles, W: int, S_cap: int):
    """Candidate extraction of the ray fallback: each ray tile's candidate
    leaf tiles, W per step.  Returns ``(a_idx (S_cap,), b_idx (S_cap*W,),
    nsteps)``; b entries ``t | bits << 16`` carry the 4 ray sub-band bits,
    pad entries point at tile T with bits 0."""
    bits = _ray_tile_hits(rfields, tiles)
    hits = bits > 0
    RT, T = hits.shape
    step, lane, nsteps = _group_positions(hits, W)
    dst = torch.where(hits, step * W + lane, S_cap * W).reshape(-1)
    t_idx = torch.arange(T, dtype=torch.int32, device=bits.device)
    b_idx = scatter_drop(S_cap * W, dst, (t_idx | (bits << 16)).reshape(-1),
                         T)
    rt_idx = torch.arange(RT, dtype=torch.int32, device=bits.device)
    a_idx = scatter_drop(S_cap, torch.where(hits, step, S_cap).reshape(-1),
                         rt_idx[:, None].expand(RT, T).reshape(-1), 0)
    return a_idx, b_idx, nsteps


def traverse_rays_tiles_fixed(bvh: BVH, points, directions, capacity: int, *,
                              alg: Optional[TileTraversal] = None,
                              pair_capacity: Optional[int] = None,
                              narrow=None):
    """Fixed-capacity tile ray traversal, with no host sync.

    ``points``/``directions`` are (3, N) ray matrices.  Returns ``(total,
    contacts, overflow, num_checks)`` as tensors on the BVH's device: the
    hit count, a ``(capacity, 2)`` int32 list of ``(leaf user index,
    1-based ray index)`` pairs in no particular order, the overflow bitmask
    (bit 0: a buffer capacity, bit 1: a slot cap; results are incomplete
    when it is set) and the number of ray-leaf tests of live bands
    (float32).  ``narrow(leaves, p, d)`` is an optional vectorised
    predicate over gathered leaves and ray coordinate tuples.
    """
    from ..raytrace import _prep_rays    # here: raytrace imports this module
    alg = alg or RAY_ALG
    G = alg.tile
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype, bvh.device)
    n_rays = p[0].shape[0]
    dev = bvh.device
    with tracing.span("rays.sort", dev):
        perm = _sort_rays(p, d)
    with tracing.span("rays.phase1", dev):
        fields, sphere, tiles, _, T = _tiled_fields(bvh, G)
        rfields, RT = _ray_tile_fields(p, d, perm, G)
    W = alg.count_w
    if pair_capacity is None:
        pair_capacity = _ray_pair_capacity(RT)
    # sorted ray position -> original 1-based ray index (0 on the padding)
    iray_map = torch.nn.functional.pad(perm.int() + 1, (0, RT * G - n_rays))
    narrow_fn = None
    if narrow is not None:
        leaves = bvh.leaves
        rflat = rfields.view(6, -1)

        def narrow_fn(gl, gr):
            return narrow(leaves[gl], tuple(rflat[:3, gr]),
                          tuple(rflat[3:, gr]))

    # the rays are the a set; the leaf, a b position, is the first column
    q = _TileQuery((rfields, fields), "ray_sphere" if sphere else "ray_box",
                   alg, capacity, bvh.leaves.index, iray_map, narrow_fn,
                   swap=True, stage="rays")
    if not _two_phase(alg, capacity):          # the fallback
        S_cap, _ = _step_caps(pair_capacity // W + RT)
        with q.span("phase1"):
            a_idx, b_idx, nsteps = _phase1_ray_tile_groups(rfields, tiles,
                                                           W, S_cap)
        total, contacts, slot_overflow = _fallback_route(q, a_idx, b_idx,
                                                         nsteps)
        overflow = (((nsteps > S_cap) | (total > capacity)).int()
                    | (slot_overflow.int() << 1))
        num_checks = (_popcount(b_idx >> 16).sum().to(torch.float32)
                      * float((G // N_BANDS) * G))
        return total, contacts, overflow, num_checks

    R = alg.run_r
    S_cap = _run_step_cap(pair_capacity // W + RT, alg)
    with q.span("phase1"):
        a_idx, run_idx, bm_words, nsteps, num_checks, run_overflow = \
            _phase1_ray_runs(rfields, tiles, W, S_cap, R, -(-T // R),
                             alg.bands)
    # pairs with hits carry 1-3 hits each, far fewer than self-contact
    # pairs, so the emit grid is sized for one hit per pair
    total, contacts, cap_overflow, slot_overflow = _two_phase_route(
        q, a_idx, run_idx, bm_words, nsteps, run_overflow,
        _step_caps(RT + capacity // alg.emit_w)[0], max(4096, capacity // 4),
        D_want=capacity // 2, decode_k=alg.decode_k)
    overflow = ((cap_overflow | (total > capacity)).int()
                | (slot_overflow.int() << 1))
    return total, contacts, overflow, num_checks


def traverse_rays_tiles(bvh: BVH, points, directions, *,
                        alg: Optional[TileTraversal] = None, narrow=None,
                        cache: Optional[BVHTraversal] = None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Tile ray traversal with overflow-driven growth
    (``tiles._grow_tiles`` around :func:`traverse_rays_tiles_fixed`), from
    a capacity of four hits per ray, ending in ``traverse_rays`` with
    ``LVTTraversal()`` for a scene past the slot caps' ceilings."""
    from ..raytrace import _traverse_rays  # raytrace imports this module
    alg = _merge_cached_alg(alg or RAY_ALG, cache)
    n_rays = int(torch.as_tensor(points).shape[1])
    if n_rays == 0 or bvh.tree.real_nodes < 1:
        return _empty_traversal(bvh, 1)
    return _grow_tiles(
        lambda c, a, pc: traverse_rays_tiles_fixed(
            bvh, points, directions, c, alg=a, pair_capacity=pc,
            narrow=narrow),
        lambda: _traverse_rays(bvh, points, directions, LVTTraversal(),
                               narrow=narrow, options=options),
        alg, _pow2_capacity(4 * n_rays, options),
        _ray_pair_capacity(-(-n_rays // alg.tile)), cache, options,
        bvh.skips)
