"""W1 and W2, the walks on the device: the kernels' wrappers and packers.

The JAX package runs the stackless leaf-vs-tree walk
(``implicitbvh_tpu/traverse/walk.py:35-141``) and DFS self-contact
(``implicitbvh_tpu/traverse/dfs.py:57-141``) as a ``lax.while_loop`` each,
inside ``jax.jit``; neither is a Pallas kernel.  Torch has no device-side
loop: the port's torch-op loops end on a host read.  On the card the loops
run as kernels with one thread per lane, each looping until its lane is
done (``csrc/walk.cu``, W1; ``csrc/dfs.cu``, W2).  A lane's path depends on
no other lane, so per-thread lanes give the lockstep loop's per-lane counts
and rows in order.  The wrappers pack the nodes, the target leaves and the
lanes into float32 records with torch ops on the device, read nothing back
and copy nothing from the host (every size is a Python int of the tree's
shape), so a CUDA graph captures them.  Each kernel is bound by its longest
lane: a chain of dependent node loads, one per step.

The wrappers launch their kernels and take CUDA tensors only.  Their plain
versions are the torch-op loops ``traverse.walk.walk_lanes_plain`` (over
``stackless_walk``) and ``traverse.dfs.dfs_lanes_plain``, which end on a
host read once every 32 steps.  The one router of each,
``traverse.walk.route_walk`` and ``traverse.dfs.dfs_single_fixed``, takes
the plain version for CPU tensors or a ``narrow`` callback and the kernel
otherwise, so nothing here imports the traverse layer.  The kernels read
float32 records: a float64 volume on the card raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..volumes import BBox, BSphere
from . import _build

MAX_LEVELS = 30     # int32 implicit indices and shifts: 2^29 leaves at most

_SPHERE, _BOX, _RAY = 0, 1, 2         # record kinds (common.cuh's MaskKind)
_SELF, _PAIR, _FLIPPED, _RAYS = range(4)  # walk.cu's row layouts


def stack_depth(levels: int, start_level: int) -> int:
    """Stack slots a DFS lane needs: each pop that pushes removes one slot
    and adds at most four, one level down."""
    return 3 * max(levels - start_level, 1) + 4


MAX_DFS_DEPTH = stack_depth(MAX_LEVELS, 1)  # dfs.cu's MAX_DEPTH (91)


def _kind(vol) -> int:
    return _SPHERE if isinstance(vol, BSphere) else _BOX


def _records(vol) -> torch.Tensor:
    """A volume batch as float32 records, one row each: a sphere
    ``(x0, x1, x2, r)``, a box ``(lo0, lo1, lo2, up0, up1, up2, 0, 0)``."""
    if isinstance(vol, BSphere):
        cols = [*vol.xs, vol.r]
    else:
        z = torch.zeros_like(vol.los[0])
        cols = [*vol.los, *vol.ups, z, z]
    rec = torch.stack(cols, 1)
    if rec.dtype != torch.float32:
        raise TypeError(f"the walk kernels take float32 volumes, got "
                        f"{rec.dtype}")
    return rec


def _ray_records(points, directions) -> torch.Tensor:
    """Rays as float32 records ``(p0, p1, p2, d0, d1, d2, 0, 0)``."""
    z = torch.zeros_like(points[0])
    rec = torch.stack([*points, *directions, z, z], 1)
    if rec.dtype != torch.float32:
        raise TypeError(f"the walk kernels take float32 rays, got "
                        f"{rec.dtype}")
    return rec


def _diag(diag, K: int, dev):
    if diag is not None:
        _build.check(diag, "diag", torch.int32, (K, 3), dev)
        return diag.data_ptr()
    return None


def _on_card(t, kernel: str):
    if not _build.cuda_device(t):
        raise ValueError(f"kernel {kernel} takes CUDA tensors, got {t.device}"
                         " (the traverse layer's router runs the plain "
                         "version for CPU tensors)")


def _ptr(t):
    return None if t is None else t.data_ptr()


class WalkArgs(NamedTuple):
    """W1's inputs as the wrapper packs them (``walk_launch``'s arguments
    but the outputs): float32 records, index tensors, and ints."""
    nodes: torch.Tensor
    leaves: torch.Tensor
    leaf_index: torch.Tensor
    skips: torch.Tensor
    lanes: torch.Tensor
    lane_index: Optional[torch.Tensor]
    dedup: Optional[torch.Tensor]
    offsets: Optional[torch.Tensor]
    K: int
    lane_kind: int
    node_kind: int
    leaf_kind: int
    index_bits: int
    write: int
    levels: int
    virtual_leaves: int
    num_nodes: int
    num_leaves: int
    start_level: int
    last_root: int
    emit: int
    ray_offset: int
    capacity: int


def pack_walk(target, start_level: int, lanes, *, flip=False,
              dedup_ileaf=None, ray_offset: int = 0, capacity: int = 0,
              offsets=None) -> WalkArgs:
    """Pack the arguments of :func:`walk_lanes` for W1, with torch ops on
    their device (no host read, no host copy)."""
    tree, idt = target.tree, target.skips.dtype
    if tree.levels > MAX_LEVELS:
        raise ValueError(f"the walk's int32 shifts hold {MAX_LEVELS} "
                         f"levels, got {tree.levels}")
    node_kind = _kind(target.nodes)
    leaf_rec = _records(target.leaves.volume)
    leaf_index = target.leaves.index.to(idt).contiguous()
    if isinstance(lanes, tuple):           # rays
        points, directions = lanes
        lane_kind, emit, lane_index = _RAY, _RAYS, None
        lane_rec = _ray_records(points, directions)
    else:
        lane_kind = _kind(lanes.volume)
        if node_kind == _SPHERE and lane_kind == _BOX:
            raise TypeError(f"cannot convert {BBox} to {BSphere}")
        emit = _SELF if dedup_ileaf is not None else \
            _FLIPPED if flip else _PAIR
        if lanes is target.leaves:         # self-contact: the same records
            lane_rec, lane_index = leaf_rec, leaf_index
        else:
            lane_rec = _records(lanes.volume)
            lane_index = lanes.index.to(idt).contiguous()
    K = lane_rec.shape[0]
    if capacity > 0:
        offsets = torch.zeros((K,), dtype=idt, device=target.device) \
            if offsets is None else offsets.to(idt).contiguous()
    else:
        offsets = None
    args = WalkArgs(
        _records(target.nodes), leaf_rec, leaf_index,
        target.skips.contiguous(), lane_rec, lane_index,
        None if dedup_ileaf is None else dedup_ileaf.to(idt).contiguous(),
        offsets, K, lane_kind, node_kind, _kind(target.leaves.volume),
        64 if idt == torch.int64 else 32, int(capacity > 0), tree.levels,
        tree.virtual_leaves, tree.num_nodes, tree.real_leaves, start_level,
        (1 << (start_level - 1)) + tree.level_nodes(start_level) - 1, emit,
        ray_offset, capacity)
    for name in ("leaf_index", "lanes", "lane_index", "dedup", "offsets"):
        t = getattr(args, name)
        if t is not None and t.device != target.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{target.device}")
    return args


def walk_lanes(target, start_level: int, lanes, *, flip=False,
               dedup_ileaf=None, ray_offset: int = 0, capacity: int = 0,
               offsets=None, diag=None):
    """One pass of the stackless walk of ``target`` (a BVH) from
    ``start_level`` for every lane; returns ``(counts (K,), out (capacity,
    2))`` in the index dtype of ``target.skips``.

    - ``lanes``: leaf lanes (a ``Leaves``: volumes and user indices) or rays
      (a ``(points, directions)`` pair of coordinate 3-tuples of (K,)
      tensors).
    - ``dedup_ileaf``: (K,) implicit leaf indices of leaf lanes that are the
      target's own leaves (self-contact): subtrees at or left of a lane's
      leaf are pruned and rows are sorted ``(min, max)`` user indices.
      Otherwise rows are ``(lane, leaf)``, ``(leaf, lane)`` with ``flip``,
      or ``(leaf, ray_offset + k + 1)`` for rays.
    - ``capacity == 0``: the count pass; else the write pass, lane k's rows
      at ``offsets[k] +`` its running count, those at or past ``capacity``
      dropped.
    - ``diag``: an int32 (K, 3) tensor that selects the kernel's diagnostic
      variant, which writes each lane's loop steps (the kernel's critical
      path), node tests and leaf tests; the other variants count nothing.

    Kernel W1 (``csrc/walk.cu``), the port's kernel for the JAX package's
    device loop ``implicitbvh_tpu/traverse/walk.py:140``; its plain version
    is ``traverse.walk.walk_lanes_plain``.  Raises for tensors off the card,
    float64 volumes, box lanes against sphere nodes (as ``convert_volume``
    does) and trees past 30 levels.
    """
    _on_card(target.skips, "W1")
    a = pack_walk(target, start_level, lanes, flip=flip,
                  dedup_ileaf=dedup_ileaf, ray_offset=ray_offset,
                  capacity=capacity, offsets=offsets)
    dev, idt = target.device, target.skips.dtype
    counts = torch.empty((a.K,), dtype=idt, device=dev)
    out = torch.zeros((capacity, 2), dtype=idt, device=dev)
    if a.K == 0:
        return counts, out
    P, I, L = _build.P, _build.I, ctypes.c_longlong
    fn = _build.kernel_fn("walk", "walk_launch",
                          [P] * 11 + [I] * 13 + [L, L, P])
    with torch.cuda.device(dev):
        _build.launch(fn, "walk", *(_ptr(t) for t in a[:8]),
                      counts.data_ptr(), out.data_ptr(),
                      _diag(diag, a.K, dev), *a[8:])
    walk_lanes.launches += 1
    return counts, out


walk_lanes.launches = 0


class DfsArgs(NamedTuple):
    """W2's inputs as the wrapper packs them (``dfs_launch``'s arguments
    but the outputs)."""
    nodes: torch.Tensor
    leaves: torch.Tensor
    leaf_index: torch.Tensor
    skips: torch.Tensor
    offsets: Optional[torch.Tensor]
    K: int
    node_kind: int
    leaf_kind: int
    index_bits: int
    write: int
    levels: int
    virtual_leaves: int
    num_nodes: int
    num_leaves: int
    depth: int
    n: int
    first: int
    capacity: int


def pack_dfs(bvh, start_level: int, capacity: int = 0,
             offsets=None) -> DfsArgs:
    """Pack the arguments of :func:`dfs_lanes` for W2, with torch ops on
    their device.  The kernel unranks each lane's initial pair from the
    start level's node count ``n`` and first index: ``n (n - 1) / 2`` pairs
    and, above the leaf level, ``n`` self pairs (``traverse/bfs.py:
    _initial_bvtt_single``); the stack holds ``3 (levels - start_level) +
    4`` pairs."""
    tree, idt = bvh.tree, bvh.skips.dtype
    depth = stack_depth(tree.levels, start_level)
    if tree.levels > MAX_LEVELS or depth > MAX_DFS_DEPTH:
        raise ValueError(f"DFS takes trees of up to {MAX_LEVELS} levels, "
                         f"got {tree.levels}")
    n = tree.level_nodes(start_level)
    K = n * (n - 1) // 2 + (n if start_level != tree.levels else 0)
    if K >= 1 << 31:
        raise ValueError(f"{K} DFS lanes at start level {start_level}: "
                         "the kernel takes fewer than 2^31")
    if capacity > 0:
        offsets = torch.zeros((K,), dtype=idt, device=bvh.device) \
            if offsets is None else offsets.to(idt).contiguous()
        if offsets.device != bvh.device:
            raise ValueError(f"offsets is on {offsets.device}, expected "
                             f"{bvh.device}")
    else:
        offsets = None
    return DfsArgs(
        _records(bvh.nodes), _records(bvh.leaves.volume),
        bvh.leaves.index.to(idt).contiguous(), bvh.skips.contiguous(),
        offsets, K, _kind(bvh.nodes), _kind(bvh.leaves.volume),
        64 if idt == torch.int64 else 32, int(capacity > 0), tree.levels,
        tree.virtual_leaves, tree.num_nodes, tree.real_leaves, depth, n,
        1 << (start_level - 1), capacity)


def dfs_lanes(bvh, start_level: int, capacity: int = 0, offsets=None,
              diag=None):
    """One pass of DFS self-contact over ``bvh`` from ``start_level``, one
    lane per initial BVTT pair; returns ``(counts (lanes,), out
    (max(capacity, 1), 2))`` in the index dtype of ``bvh.skips``.

    ``capacity == 0``: the count pass (``out`` one zero row).  Else the
    write pass: lane k's sorted ``(min, max)`` user-index pairs at
    ``offsets[k] +`` its running count, those at or past ``capacity``
    dropped.  ``diag``: an int32 (lanes, 3) tensor that selects the kernel's
    diagnostic variant, which writes each lane's loop steps, node-pair tests
    and leaf-pair tests.

    Kernel W2 (``csrc/dfs.cu``), the port's kernel for the JAX package's
    device loop ``implicitbvh_tpu/traverse/dfs.py:139``; its plain version
    is ``traverse.dfs.dfs_lanes_plain``.  Raises for tensors off the card
    and float64 volumes.
    """
    _on_card(bvh.skips, "W2")
    a = pack_dfs(bvh, start_level, capacity, offsets)
    dev, idt = bvh.device, bvh.skips.dtype
    counts = torch.empty((a.K,), dtype=idt, device=dev)
    out = torch.zeros((max(capacity, 1), 2), dtype=idt, device=dev)
    if a.K == 0:
        return counts, out
    P, I, L = _build.P, _build.I, ctypes.c_longlong
    fn = _build.kernel_fn("dfs", "dfs_launch", [P] * 8 + [I] * 12 + [L, P])
    with torch.cuda.device(dev):
        _build.launch(fn, "dfs", *(_ptr(t) for t in a[:5]),
                      counts.data_ptr(), out.data_ptr(),
                      _diag(diag, a.K, dev), *a[5:])
    dfs_lanes.launches += 1
    return counts, out


dfs_lanes.launches = 0
