"""Sharded contact and ray queries over a ``torch.distributed`` device mesh.

Counterpart of ``implicitbvh_tpu/parallel/sharding.py``: the query lanes
(leaves, rays, or the superpair list of the tile engine) are split over
the ranks of a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh`,
while every rank holds the whole BVH (each builds it from the same inputs,
and the build is deterministic).  Every public function is SPMD: each rank
calls it with its own mesh.

- The tile engines run level A of phase 1 (the supertile overlap) on every
  rank, deal the superpair list round-robin (rank ``d`` takes superpairs
  ``d, d + n_dev, ...``: the list is row-major, so contiguous slices would
  pile the dense diagonal onto the low ranks) and run the rest of the
  two-phase route (``traverse/tiles.py:_two_phase_slice``) on the rank's
  share with per-rank step caps.  A tile pair lies in one superpair, so
  the ranks' contact sets are disjoint.
- Rays are split in contiguous slices; the tile ray engine runs per rank
  on its slice, the walk with global 1-based ray indices.
- The walk engine splits the leaf lanes in contiguous slices and prunes
  with the lanes' global sorted positions.

Each public function is a collective-free local function
``_local_<name>(..., rank, n_dev)``, which returns the rank's ``(total,
contacts, overflow)``, and one ``all_reduce`` of ``[total, overflow]``
(int64: gloo has no bool sum) on the mesh's group.  The result is the JAX
package's ``(total, contacts, counts, overflow)``: ``total`` the global
count, ``contacts`` and ``counts`` ``DTensor``\\ s sharded on dim 0 (global
shapes ``(n_dev * capacity_per_device, 2)`` and ``(n_dev,)``; ``.to_local()``
gives the rank's slice, ``.full_tensor()`` the JAX package's global array)
and ``overflow`` a bool tensor.  The local functions make no host sync:
on the card the walks are kernel W1 (``traverse/walk.py``), unless a
``narrow`` callback takes the torch-op loop, which ends on a host read.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..build import BVH, build
from ..raytrace import _prep_rays, _walk_rays
from ..traverse.lvt import _scan, default_start_level_lvt
from ..traverse.tiles import (TileTraversal, _phase1_superpairs,
                              _run_step_cap, _step_caps, _tile_query,
                              _two_phase, _two_phase_slice)
from ..traverse.walk import route_walk
from ..utils import resolve_device
from ..volumes import BBox, BSphere

AXIS = "data"


def make_mesh(device_type=None, axis: str = AXIS):
    """1-D device mesh over every rank of the default process group.

    ``device_type`` None means ``"cuda"``, which raises on a machine with no
    card.  The caller initialises the default group first
    (``torch.distributed.init_process_group``: ``nccl`` on the card,
    ``gloo`` on the CPU); without one this raises."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = resolve_device(device_type).type
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) on every rank first")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _rank_and_size(mesh, axis: str):
    return mesh.get_local_rank(axis), mesh.size(0)


def _stream_capacity(capacity_per_device: int) -> int:
    """The emit stream's capacity on a rank: the stream takes aligned
    1024-contact quanta, so the capacity is rounded up (the result is
    sliced back)."""
    return max(1024, -(-capacity_per_device // 1024) * 1024)


def _assemble(mesh, axis: str, total, contacts, overflow):
    """The one all-reduce of ``[total, overflow]`` on the mesh's group, and
    the rank's contacts and count as ``DTensor`` shards (the count in the
    total's dtype: int32 on the tile paths, the index dtype on the walk)."""
    from torch.distributed.tensor import DTensor, Shard
    both = torch.stack([total.long(), overflow.long()])
    dist.all_reduce(both, group=mesh.get_group(axis))
    counts = total.reshape(1)
    return (both[0].to(total.dtype),
            DTensor.from_local(contacts, mesh, [Shard(0)], run_check=False),
            DTensor.from_local(counts, mesh, [Shard(0)], run_check=False),
            both[1] > 0)


# --------------------------------------------------------------------------
# The walk engine
# --------------------------------------------------------------------------

def _local_sharded_self_contact(bvh: BVH, capacity_per_device: int,
                                rank: int, n_dev: int,
                                start_level: Optional[int] = None,
                                narrow=None):
    """Rank ``rank``'s share of :func:`sharded_self_contact`: the walk of
    its contiguous slice of leaf lanes, a counting and a writing pass.
    Returns ``(total, contacts (capacity_per_device, 2), overflow)``."""
    if start_level is None:
        start_level = default_start_level_lvt(bvh)
    n = bvh.num_leaves
    if n % n_dev != 0:
        raise ValueError(f"num_leaves {n} not divisible by mesh size {n_dev}")
    per_dev = n // n_dev
    lo = rank * per_dev
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    # the pruning rule needs the lanes' global sorted positions; the lane
    # slice is a view, packed on the device by the walk
    dedup = torch.arange(lo + 1, lo + per_dev + 1, dtype=bvh.skips.dtype,
                         device=bvh.device) + leaf_base
    lanes = bvh.leaves[lo:lo + per_dev]

    def walk(**kw):
        return route_walk(bvh, start_level, lanes, dedup_ileaf=dedup,
                          narrow=narrow, **kw)

    offsets, total = _scan(walk()[0])
    out = walk(capacity=capacity_per_device, offsets=offsets)[1]
    return total, out, total > capacity_per_device


def sharded_self_contact(mesh, bvh: BVH, capacity_per_device: int,
                         start_level: Optional[int] = None, narrow=None,
                         axis: str = AXIS):
    """Self-contact by the stackless walk with the leaf lanes split over
    ``mesh`` (any density; kernel W1 on the card).

    Returns ``(total, contacts, counts, overflow)``: the global contact
    count; the ``(n_dev * capacity_per_device, 2)`` contact ``DTensor``
    with each rank's sorted ``(min, max)`` pairs a prefix of its slice; the
    ``(n_dev,)`` per-rank counts (a count past the capacity means that
    slice is truncated); and whether any rank overflowed.  The leaf count
    must be a multiple of the mesh size."""
    rank, n_dev = _rank_and_size(mesh, axis)
    return _assemble(mesh, axis, *_local_sharded_self_contact(
        bvh, capacity_per_device, rank, n_dev, start_level, narrow))


# --------------------------------------------------------------------------
# Rays
# --------------------------------------------------------------------------

def _local_sharded_rays(bvh: BVH, points, directions,
                        capacity_per_device: int, rank: int, n_dev: int,
                        start_level: int = 1, narrow=None,
                        engine: str = "tiles", alg=None):
    """Rank ``rank``'s share of :func:`sharded_rays`: its contiguous slice
    of rays.  Returns ``(total, contacts (capacity_per_device, 2),
    overflow)`` with global 1-based ray indices."""
    from ..traverse.ray_tiles import traverse_rays_tiles_fixed
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype, bvh.device)
    nrays = p[0].shape[0]
    if nrays % n_dev != 0:
        raise ValueError(f"num rays {nrays} not divisible by mesh {n_dev}")
    per_dev = nrays // n_dev
    lo = rank * per_dev
    p = tuple(c[lo:lo + per_dev] for c in p)
    d = tuple(c[lo:lo + per_dev] for c in d)
    cap_dev = capacity_per_device
    if engine == "tiles":
        total, contacts, ov, _ = traverse_rays_tiles_fixed(
            bvh, torch.stack(p), torch.stack(d), _stream_capacity(cap_dev),
            alg=alg or TileTraversal(row_cap=8, emit_w=8), narrow=narrow)
        col = contacts[:, 1]
        contacts = torch.stack([contacts[:, 0],
                                torch.where(col > 0, col + lo, 0)], 1)
        return total, contacts[:cap_dev], (ov > 0) | (total > cap_dev)
    offsets, total = _scan(_walk_rays(bvh, p, d, start_level, narrow,
                                      ray_offset=lo)[0])
    out = _walk_rays(bvh, p, d, start_level, narrow, ray_offset=lo,
                     capacity=cap_dev, offsets=offsets)[1]
    return total, out, total > cap_dev


def sharded_rays(mesh, bvh: BVH, points, directions,
                 capacity_per_device: int, start_level: int = 1,
                 narrow=None, axis: str = AXIS, engine: str = "tiles",
                 alg=None, interpret: Optional[bool] = None):
    """Ray traversal with the rays, (3, N) matrices, split over ``mesh``.

    ``engine="tiles"`` (the default) runs the tile ray engine
    (``traverse_rays_tiles_fixed`` with ``alg``, by default
    ``TileTraversal(row_cap=8, emit_w=8)``) on each rank's slice;
    ``engine="walk"`` the stackless walk from ``start_level``.  Returns
    ``(total, contacts, counts, overflow)`` as :func:`sharded_self_contact`
    does, with ``(leaf user index, global 1-based ray index)`` rows.  The
    ray count must be a multiple of the mesh size.  ``interpret`` is the
    JAX package's Pallas switch and is not read: each kernel runs on the
    tensors' device."""
    rank, n_dev = _rank_and_size(mesh, axis)
    return _assemble(mesh, axis, *_local_sharded_rays(
        bvh, points, directions, capacity_per_device, rank, n_dev,
        start_level, narrow, engine, alg))


# --------------------------------------------------------------------------
# The tile engine on a superpair share
# --------------------------------------------------------------------------

def _local_tiles(bvh1: BVH, bvh2: Optional[BVH], capacity_per_device: int,
                 rank: int, n_dev: int, alg, narrow):
    """Rank ``rank``'s share of the sharded tile traversal of ``bvh1``
    with itself (``bvh2`` None) or against ``bvh2``: level A on the whole
    grid, then the two-phase route on superpairs ``rank, rank + n_dev,
    ...`` with the per-rank step caps.  Returns ``(total, contacts
    (capacity_per_device, 2), overflow)``."""
    cap_dev = capacity_per_device
    cap_stream = _stream_capacity(cap_dev)
    q = _tile_query(bvh1, bvh2, cap_stream, alg, None, narrow)
    alg = q.alg
    if not _two_phase(alg, cap_stream):
        raise ValueError("sharded tile path needs pair_cap <= 128 "
                         "(per-pair rows append as one lane row)")
    S_loc = _run_step_cap(-(-(q.pair_capacity // alg.count_w + q.T_a)
                            // n_dev), alg)
    si, sj, nsp, p1_over = _phase1_superpairs(q.tiles, q.pair_capacity,
                                              q.tiles2, sp_round=16 * n_dev)
    SP_loc = si.shape[0] // n_dev
    nsp_loc = ((nsp - rank + n_dev - 1) // n_dev).clamp(0, SP_loc)
    # emit steps per rank <= the a-tiles of its share (< S_loc) plus one
    # partial group of emit_w per a-tile
    S2_cap, _ = _step_caps(S_loc + cap_stream // (8 * alg.emit_w))
    total, contacts, cap_over, slot_over, _ = _two_phase_slice(
        q, si[rank::n_dev].contiguous(), sj[rank::n_dev].contiguous(),
        nsp_loc, S_loc, S2_cap, max(4096, cap_stream // 8), D_want=0,
        decode_k=0)
    overflow = slot_over | cap_over | (total > cap_dev) | p1_over
    return total, contacts[:cap_dev], overflow


def _local_sharded_tile_self_contact(bvh: BVH, capacity_per_device: int,
                                     rank: int, n_dev: int, *, alg=None,
                                     narrow=None):
    """Rank ``rank``'s share of :func:`sharded_tile_self_contact`; no host
    sync.  Returns ``(total, contacts, overflow)``."""
    return _local_tiles(bvh, None, capacity_per_device, rank, n_dev, alg,
                        narrow)


def sharded_tile_self_contact(mesh, bvh: BVH, capacity_per_device: int, *,
                              alg=None, narrow=None, axis: str = AXIS,
                              interpret: Optional[bool] = None):
    """Self-contact on the tile engine's two-phase route with the
    superpair list dealt round-robin over ``mesh``: every rank runs level
    A, then band bits, run lists, the count kernel, regroup, the emit
    kernel and the finish on its share, against the whole leaf set.

    ``alg`` is a :class:`TileTraversal` with ``pair_cap <= 128`` (else
    ``ValueError``); the fixed shapes have no growth, and the overflow flag
    reports a capacity or slot cap passed on any rank.  Returns ``(total,
    contacts, counts, overflow)`` as :func:`sharded_self_contact` does.
    ``interpret`` is not read (see :func:`sharded_rays`)."""
    rank, n_dev = _rank_and_size(mesh, axis)
    return _assemble(mesh, axis, *_local_sharded_tile_self_contact(
        bvh, capacity_per_device, rank, n_dev, alg=alg, narrow=narrow))


def _local_sharded_tile_pair(bvh1: BVH, bvh2: BVH, capacity_per_device: int,
                             rank: int, n_dev: int, *, alg=None,
                             narrow=None):
    """Rank ``rank``'s share of :func:`sharded_tile_pair`; no host sync.
    Returns ``(total, contacts, overflow)``."""
    return _local_tiles(bvh1, bvh2, capacity_per_device, rank, n_dev, alg,
                        narrow)


def sharded_tile_pair(mesh, bvh1: BVH, bvh2: BVH, capacity_per_device: int,
                      *, alg=None, narrow=None, axis: str = AXIS,
                      interpret: Optional[bool] = None):
    """Two-BVH contact on the tile engine, sharded as
    :func:`sharded_tile_self_contact` is: level A over the full S1 x S2
    supertile grid, the superpair list dealt round-robin, each rank's
    share through the two-phase route on both field sets.  Returns
    ``(total, contacts, counts, overflow)`` with tree-order ``(index in
    bvh1, index in bvh2)`` rows.  Both BVHs must have leaves of one kind.
    ``interpret`` is not read (see :func:`sharded_rays`)."""
    rank, n_dev = _rank_and_size(mesh, axis)
    return _assemble(mesh, axis, *_local_sharded_tile_pair(
        bvh1, bvh2, capacity_per_device, rank, n_dev, alg=alg,
        narrow=narrow))


# --------------------------------------------------------------------------
# The moving-geometry step
# --------------------------------------------------------------------------

def _local_sharded_rebuild_traverse_step(x, r, rank: int, n_dev: int,
                                         node_kind=BBox,
                                         capacity_per_device: int = 1 << 16,
                                         engine: str = "tiles", alg=None):
    """Rank ``rank``'s share of one step of
    :func:`sharded_rebuild_traverse_step`: ``build`` from the spheres
    ``(x, r)``, then the tile or the walk engine.  Returns ``(total,
    contacts, overflow)``."""
    bvh = build(BSphere(x, r), node_kind)
    if engine == "tiles":
        return _local_sharded_tile_self_contact(
            bvh, capacity_per_device, rank, n_dev, alg=alg)
    return _local_sharded_self_contact(bvh, capacity_per_device, rank, n_dev)


def sharded_rebuild_traverse_step(mesh, node_kind=BBox,
                                  capacity_per_device: int = 1 << 16,
                                  axis: str = AXIS, engine: str = "tiles",
                                  alg=None):
    """The moving-geometry step over ``mesh``: every rank rebuilds the BVH
    from the leaf spheres and runs sharded self-contact, by the tile engine
    (``engine="tiles"``, with ``alg``; its slot caps must cover the scene,
    since the fixed shapes have no growth) or the walk (``"walk"``).

    Returns ``step(x, r) -> (total, contacts, counts, overflow)``, ``x``
    the (N, 3) centres and ``r`` the (N,) radii."""
    def step(x, r):
        rank, n_dev = _rank_and_size(mesh, axis)
        return _assemble(mesh, axis, *_local_sharded_rebuild_traverse_step(
            x, r, rank, n_dev, node_kind, capacity_per_device, engine, alg))

    return step
