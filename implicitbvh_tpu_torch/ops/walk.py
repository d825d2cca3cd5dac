"""W1 and W2, the walks on the device: the kernels' wrappers and packers.

The JAX package runs the stackless leaf-vs-tree walk
(``implicitbvh_tpu/traverse/walk.py:35-141``) and DFS self-contact
(``implicitbvh_tpu/traverse/dfs.py:57-141``) as a ``lax.while_loop`` each,
inside ``jax.jit``; neither is a Pallas kernel.  Torch has no device-side
loop: the port's torch-op loops end on a host read.  On the card the loops
run as kernels (``csrc/walk.cu``, W1; ``csrc/dfs.cu``, W2) whose time is the
longest chain of dependent steps.  So each splits a long lane's work
without changing its rows or their order: W1 walks few lanes in two stages
split by subtree at a level fixed by :func:`split_level`, W2 runs a lane's
stack as work items in rounds of a few steps each (:func:`dfs_schedule`),
and both place each piece's rows by a scan within its lane.  A lane's rows
are the lockstep loop's, in order, at ``offsets[lane]``.  The wrappers
pack the nodes, the target leaves and the lanes into float32 or float64
records with torch ops on the device, allocate the kernels' work lists,
read nothing back and copy nothing from the host (every size is a Python
int of the tree's shape), so a CUDA graph captures them.

The wrappers launch their kernels and take CUDA tensors only.  Their plain
versions are the torch-op loops ``traverse.walk.walk_lanes_plain`` (over
``stackless_walk``) and ``traverse.dfs.dfs_lanes_plain``, which end on a
host read once every 32 steps.  The one router of each,
``traverse.walk.route_walk`` and ``traverse.dfs.dfs_single_fixed``, takes
the plain version for CPU tensors or a ``narrow`` callback and the kernel
otherwise, so nothing here imports the traverse layer.  Values are float32
or float64; a walk of float64 lanes against a float32 tree (or the other
way round) runs in float64 with each side's own conversions rounded in its
own type, as torch and JAX promote.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..volumes import BBox, BSphere
from . import _build

MAX_LEVELS = 30     # int32 implicit indices and shifts: 2^29 leaves at most
SPLIT_LANES = 4096  # W1 runs one thread per lane at or past this many lanes
SPLIT_SLOTS = 1 << 21   # W1's stage-1 slots (lanes x slots a lane) at most
DFS_BUDGET = 32     # W2's steps an item in a round that is not the last
DFS_MAX_ROUNDS = 16     # dfs.cu's MAX_ROUNDS
DFS_ITEMS_PER_LANE = 32  # W2's work list: items a lane
DFS_MAX_ITEMS = 1 << 26

_SPHERE, _BOX, _RAY = 0, 1, 2         # record kinds (common.cuh's MaskKind)
_SELF, _PAIR, _FLIPPED, _RAYS = range(4)  # walk.cu's row layouts


def stack_depth(levels: int, start_level: int) -> int:
    """Stack slots a DFS lane needs: each pop that pushes removes one slot
    and adds at most four, one level down."""
    return 3 * max(levels - start_level, 1) + 4


MAX_DFS_DEPTH = stack_depth(MAX_LEVELS, 1)  # dfs.cu's MAX_DEPTH (91)


def split_level(K: int, levels: int, start_level: int, roots: int) -> int:
    """W1's split level s for ``K`` lanes walking ``roots`` start-level
    roots of a tree of ``levels`` levels: the start level (one stage, a
    thread a lane) from ``SPLIT_LANES`` lanes on; below it, halfway down
    from the start level, raised until the lanes' slots (a lane: one per
    level-s node under its roots) fit in ``SPLIT_SLOTS``."""
    if K >= SPLIT_LANES:
        return start_level
    s = start_level + (levels - start_level + 1) // 2
    while s > start_level and K * (roots << (s - start_level)) > SPLIT_SLOTS:
        s -= 1
    return s


def dfs_schedule(K: int, levels: int, start_level: int):
    """W2's ``(budget, rounds, capacity)`` for ``K`` lanes from
    ``start_level``: ``DFS_BUDGET`` steps an item in a round; rounds enough
    to halve the largest item ``levels - start_level - 2`` times (a lane's
    largest subtree of items, a self pair's, halves a round); a work list
    of ``DFS_ITEMS_PER_LANE`` items a lane (an item that finds it full runs
    on in place)."""
    rounds = min(max(levels - start_level - 2, 1), DFS_MAX_ROUNDS)
    cap = max(min(K * DFS_ITEMS_PER_LANE, DFS_MAX_ITEMS), K)
    return DFS_BUDGET, rounds, cap


def _kind(vol) -> int:
    return _SPHERE if isinstance(vol, BSphere) else _BOX


def _value_dtype(*dtypes):
    """The walk's value type: float64 if any side is, else float32."""
    for d in dtypes:
        if d not in (torch.float32, torch.float64):
            raise TypeError(f"the walk kernels take float32 or float64 "
                            f"volumes, got {d}")
    return torch.float64 if torch.float64 in dtypes else torch.float32


def _records(vol, dtype) -> torch.Tensor:
    """A volume batch as records of ``dtype``, one row each: a sphere
    ``(x0, x1, x2, r)``, a box ``(lo0, lo1, lo2, up0, up1, up2, 0, 0)``."""
    if isinstance(vol, BSphere):
        cols = [*vol.xs, vol.r]
    else:
        z = torch.zeros_like(vol.los[0])
        cols = [*vol.los, *vol.ups, z, z]
    return torch.stack(cols, 1).to(dtype)


def _ray_records(points, directions) -> torch.Tensor:
    """Rays as records ``(p0, p1, p2, d0, d1, d2, 0, 0)`` of their own
    type."""
    z = torch.zeros_like(points[0])
    return torch.stack([*points, *directions, z, z], 1)


def _tree_dtype(tree) -> torch.dtype:
    """The value type of a BVH, whose nodes and leaves share one."""
    dt = tree.leaves.volume.dtype
    if tree.nodes.dtype != dt:
        raise TypeError(f"the BVH's nodes are {tree.nodes.dtype} and its "
                        f"leaves {dt}")
    return dt


def _diag(diag, K: int, dev):
    if diag is not None:
        _build.check(diag, "diag", torch.int32, (K + 2, 4), dev)
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
    but the outputs and the work list): records, index tensors, and ints."""
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
    value_bits: int
    lane_single: int
    tree_single: int
    write: int
    levels: int
    virtual_leaves: int
    num_nodes: int
    num_leaves: int
    start_level: int
    last_root: int
    emit: int
    split: int
    M: int
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
    tree_dt = _tree_dtype(target)
    leaf_index = target.leaves.index.to(idt).contiguous()
    rays = isinstance(lanes, tuple)
    lane_dt = lanes[0][0].dtype if rays else lanes.volume.dtype
    if rays and lane_dt != tree_dt:
        raise TypeError(f"rays of {lane_dt} against a BVH of {tree_dt}: "
                        "traverse_rays gives rays the BVH's type")
    dt = _value_dtype(lane_dt, tree_dt)
    leaf_rec = _records(target.leaves.volume, dt)
    if rays:
        lane_kind, emit, lane_index = _RAY, _RAYS, None
        lane_rec = _ray_records(*lanes)
    else:
        lane_kind = _kind(lanes.volume)
        if node_kind == _SPHERE and lane_kind == _BOX:
            raise TypeError(f"cannot convert {BBox} to {BSphere}")
        emit = _SELF if dedup_ileaf is not None else \
            _FLIPPED if flip else _PAIR
        if lanes is target.leaves:         # self-contact: the same records
            lane_rec, lane_index = leaf_rec, leaf_index
        else:
            lane_rec = _records(lanes.volume, dt)
            lane_index = lanes.index.to(idt).contiguous()
    K = lane_rec.shape[0]
    roots = tree.level_nodes(start_level)
    split = split_level(K, tree.levels, start_level, roots)
    if capacity > 0:
        offsets = torch.zeros((K,), dtype=idt, device=target.device) \
            if offsets is None else offsets.to(idt).contiguous()
    else:
        offsets = None
    wide = dt == torch.float64
    args = WalkArgs(
        _records(target.nodes, dt), leaf_rec, leaf_index,
        target.skips.contiguous(), lane_rec, lane_index,
        None if dedup_ileaf is None else dedup_ileaf.to(idt).contiguous(),
        offsets, K, lane_kind, node_kind, _kind(target.leaves.volume),
        64 if idt == torch.int64 else 32, 64 if wide else 32,
        int(wide and lane_dt == torch.float32),
        int(wide and tree_dt == torch.float32), int(capacity > 0),
        tree.levels, tree.virtual_leaves, tree.num_nodes, tree.real_leaves,
        start_level, (1 << (start_level - 1)) + roots - 1, emit, split,
        roots << (split - start_level) if split > start_level else 0,
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
    - ``diag``: an int32 (K + 2, 4) tensor that selects the kernel's
      diagnostic variant, which writes each lane's steps, node tests and
      leaf tests (summed over its stage-1 walk and its subtrees) and its
      longest single walk (the longest chain of dependent steps a thread
      runs), then the bits of the SMs that ran a walk (five words), the
      number of walks, 0 and the largest grid (blocks) that ran one; the
      other variants count nothing.  The write pass counts its count run
      only.

    Kernel W1 (``csrc/walk.cu``), the port's kernel for the JAX package's
    device loop ``implicitbvh_tpu/traverse/walk.py:140``; its plain version
    is ``traverse.walk.walk_lanes_plain``.  With fewer than ``SPLIT_LANES``
    lanes it splits them by subtree at :func:`split_level`.  Raises for
    tensors off the card, values other than float32 and float64, rays not
    of the BVH's type, box lanes against sphere nodes (as
    ``convert_volume`` does) and trees past 30 levels.
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
    # stage 1's slots (the launcher marks them), their first rows (write
    # pass) and stage 2's two item counters, made anew for each call
    slots = a.K * a.M
    own = torch.empty((slots,), dtype=torch.int64, device=dev) \
        if slots else None
    pos = torch.empty((slots,), dtype=torch.int64, device=dev) \
        if slots and a.write else None
    work = torch.empty((2,), dtype=torch.int32, device=dev) \
        if slots else None
    P, I, L = _build.P, _build.I, ctypes.c_longlong
    fn = _build.kernel_fn("walk", "walk_launch",
                          [P] * 14 + [I] * 18 + [L, L, P])
    with torch.cuda.device(dev):
        _build.launch(fn, "walk", *(_ptr(t) for t in a[:8]),
                      counts.data_ptr(), out.data_ptr(),
                      _diag(diag, a.K, dev), _ptr(own), _ptr(pos),
                      _ptr(work), *a[8:])
    tracing.count("launches.walk_lanes")
    return counts, out



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
    value_bits: int
    write: int
    levels: int
    virtual_leaves: int
    num_nodes: int
    num_leaves: int
    depth: int
    n: int
    first: int
    budget: int
    rounds: int
    cap: int
    capacity: int


def pack_dfs(bvh, start_level: int, capacity: int = 0,
             offsets=None) -> DfsArgs:
    """Pack the arguments of :func:`dfs_lanes` for W2, with torch ops on
    their device.  The kernel unranks each lane's initial pair from the
    start level's node count ``n`` and first index: ``n (n - 1) / 2`` pairs
    and, above the leaf level, ``n`` self pairs (``traverse/bfs.py:
    _initial_bvtt_single``); the stack holds ``3 (levels - start_level) +
    4`` pairs; budget, rounds and the work list's capacity are
    :func:`dfs_schedule`'s."""
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
    dt = _value_dtype(_tree_dtype(bvh))
    return DfsArgs(
        _records(bvh.nodes, dt), _records(bvh.leaves.volume, dt),
        bvh.leaves.index.to(idt).contiguous(), bvh.skips.contiguous(),
        offsets, K, _kind(bvh.nodes), _kind(bvh.leaves.volume),
        64 if idt == torch.int64 else 32,
        64 if dt == torch.float64 else 32, int(capacity > 0), tree.levels,
        tree.virtual_leaves, tree.num_nodes, tree.real_leaves, depth, n,
        1 << (start_level - 1), *dfs_schedule(K, tree.levels, start_level),
        capacity)


def dfs_lanes(bvh, start_level: int, capacity: int = 0, offsets=None,
              diag=None):
    """One pass of DFS self-contact over ``bvh`` from ``start_level``, one
    lane per initial BVTT pair; returns ``(counts (lanes,), out
    (max(capacity, 1), 2))`` in the index dtype of ``bvh.skips``.

    ``capacity == 0``: the count pass (``out`` one zero row).  Else the
    write pass: lane k's sorted ``(min, max)`` user-index pairs at
    ``offsets[k] +`` its running count, those at or past ``capacity``
    dropped.  ``diag``: an int32 (lanes + 2, 4) tensor that selects the
    kernel's diagnostic variant, which writes each lane's steps, node-pair
    tests and leaf-pair tests (summed over its work items) and its longest
    item, then the bits of the SMs that ran an item (five words), the
    number of items, the items that found the work list full and ran on in
    place, and the largest grid (blocks) that ran one; the write pass
    counts its counting rounds only.

    Kernel W2 (``csrc/dfs.cu``), the port's kernel for the JAX package's
    device loop ``implicitbvh_tpu/traverse/dfs.py:139``, in rounds of work
    items (:func:`dfs_schedule`); its plain version is
    ``traverse.dfs.dfs_lanes_plain``.  Raises for tensors off the card and
    values other than float32 and float64.
    """
    _on_card(bvh.skips, "W2")
    a = pack_dfs(bvh, start_level, capacity, offsets)
    dev, idt = bvh.device, bvh.skips.dtype
    counts = torch.empty((a.K,), dtype=idt, device=dev)
    out = torch.zeros((max(capacity, 1), 2), dtype=idt, device=dev)
    if a.K == 0:
        return counts, out
    # the work list and its counters, made anew for each call (the launcher
    # sets the counters): pair, lane, first child, children, own rows, and
    # in the write pass the subtree's rows and the first row
    i32 = [torch.empty(shape, dtype=torch.int32, device=dev)
           for shape in ((a.cap, 2), (a.cap,), (a.cap,), (a.cap,))]
    i64 = [torch.empty((a.cap,), dtype=torch.int64, device=dev)
           if k == 0 or a.write else None for k in range(3)]
    ctl = torch.empty((3 * a.rounds + 2,), dtype=torch.int32, device=dev)
    P, I, L = _build.P, _build.I, ctypes.c_longlong
    fn = _build.kernel_fn("dfs", "dfs_launch", [P] * 16 + [I] * 16 + [L, P])
    with torch.cuda.device(dev):
        _build.launch(fn, "dfs", *(_ptr(t) for t in a[:5]),
                      counts.data_ptr(), out.data_ptr(),
                      _diag(diag, a.K, dev), *(_ptr(t) for t in i32 + i64),
                      ctl.data_ptr(), *a[5:])
    tracing.count("launches.dfs_lanes")
    return counts, out

