"""Stackless leaf-vs-tree walk: the core of the LVT traversals.

Counterpart of ``implicitbvh_tpu/traverse/walk.py:35-141``.  Every lane (a
leaf or a ray) carries only its current implicit node index:

- on a hit at a node level, descend to the left child (``inode * 2``);
- otherwise climb over the trailing ones of the index (the right-child
  edges below the deepest unexplored right sibling) and step right; the
  climb is capped at ``start_level``, because the walk covers a forest of
  roots: a lane whose root is exhausted steps to the next root, or to 0
  when there is none.

Output takes two passes, count and write: the write pass scatters each
lane's contacts at ``offsets[lane] + running count``.

:func:`route_walk`, the walk's one router, takes a declarative lane spec
(leaf lanes or rays, the dedup prune of self-contact, ``flip``, the ray
offset).  On the card with no ``narrow`` it launches kernel W1
(``ops.walk_lanes``, ``csrc/walk.cu``): the lanes run on the device until
each is done, few lanes split by subtree without changing their rows, with
no host sync, as the JAX package's ``lax.while_loop`` runs on the device;
float32 and float64 volumes, promoted as torch promotes.  For CPU tensors
it runs W1's plain version :func:`walk_lanes_plain`, the torch-op loop
:func:`stackless_walk`.  A ``narrow`` callback is Python, which no kernel
can call, so with one the walk runs :func:`walk_lanes_plain` on every
device: an explicit route chosen by the argument, not a fallback.

:func:`stackless_walk` runs all lanes in lockstep in torch ops.  Torch has
no device-side loop, so the test ``any(inode > 0)`` that ends it is a host
sync.  Lanes that are done stay at 0 and a step leaves them alone, so the
body runs in blocks of ``BLOCK_STEPS`` steps with one test per block: the
result is that of testing every step, at most ``BLOCK_STEPS - 1`` idle
steps later.  The counters ``walk.steps`` and ``syncs.walk.end`` of
``tracing`` count the steps run and the tests made.

Per-lane shifts are int32: ``(cur + 1) << (levels - level)`` reaches
``2^levels``, so trees of up to 30 levels (2^29 leaves) fit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import tracing
from ..ops._build import cuda_device
from ..ops.walk import MAX_LEVELS, walk_lanes
from ..tree import ImplicitTree, isvirtual_lanes, memory_index_lanes
from ..utils import floor_ilog2, trailing_ones
from ..volumes import Volume, convert_volume, iscontact, isintersection

BLOCK_STEPS = 32        # loop steps between two tests of the end condition


def stackless_walk(
    tree: ImplicitTree,
    nodes: Volume,
    target_leaves,
    skips: torch.Tensor,
    start_level: int,
    node_test: Callable,           # (node volumes [K]) -> bool[K]
    leaf_test: Callable,           # (Leaves [K]) -> bool[K]
    emit: Callable,                # (Leaves [K]) -> int[K, 2]
    num_lanes: int,
    dedup_ileaf: Optional[torch.Tensor] = None,   # int[K] implicit leaf index
    capacity: int = 0,
    offsets: Optional[torch.Tensor] = None,       # int[K] write offsets
):
    """Run the walk for all lanes; returns ``(counts[K], out[capacity, 2])``.

    With ``capacity == 0`` this is the counting pass.  With a capacity and
    per-lane ``offsets``, lane k's contacts go to rows ``offsets[k] +
    (its running count)``; rows at or past ``capacity`` are dropped.

    ``dedup_ileaf``: subtrees whose rightmost leaf is at or left of the
    lane's own implicit leaf index are pruned (self-traversal reports each
    pair once).
    """
    levels = tree.levels
    if levels > MAX_LEVELS:
        raise ValueError(f"the walk's int32 shifts hold {MAX_LEVELS} levels, "
                         f"got {levels}")
    num_n = max(tree.num_nodes, 1)
    num_l = tree.real_leaves
    idt, dev = skips.dtype, skips.device

    first_root = 1 << (start_level - 1)
    last_root = first_root + tree.level_nodes(start_level) - 1
    leaf_base = (1 << (levels - 1)) - 1   # leaf j has implicit index j + base

    inode = torch.full((num_lanes,), first_root, dtype=idt, device=dev)
    counts = torch.zeros((num_lanes,), dtype=idt, device=dev)
    # one row past the capacity takes the writes that are dropped
    out = torch.zeros((capacity + 1, 2), dtype=idt, device=dev)
    if offsets is None:
        offsets = torch.zeros((num_lanes,), dtype=idt, device=dev)

    def body(inode, counts):
        active = inode > 0
        cur = inode.clamp(min=1)
        level = floor_ilog2(cur) + 1          # 1-based level of the node

        skip = isvirtual_lanes(tree, cur, level)   # a virtual right sibling
        if dedup_ileaf is not None:
            rightmost = ((cur + 1) << (levels - level)) - 1
            skip = skip | (rightmost <= dedup_ileaf)
        live = active & ~skip
        at_leaf = level == levels

        # gathers are clamped, so idle lanes read valid memory
        if tree.num_nodes > 0:
            mem0 = (memory_index_lanes(tree, cur, skips, level)
                    - 1).clamp(0, num_n - 1)
            descend = live & ~at_leaf & node_test(nodes[mem0.long()])
        else:       # a single-leaf tree stores no node
            descend = torch.zeros_like(active)

        leaf = target_leaves[(cur - leaf_base - 1).clamp(0, num_l - 1).long()]
        hit_leaf = live & at_leaf & leaf_test(leaf)
        if capacity > 0:
            pos = torch.where(hit_leaf, offsets + counts, capacity)
            out[pos.clamp(max=capacity).long()] = emit(leaf).to(idt)
        counts = counts + hit_leaf.to(idt)

        t = trailing_ones(cur)
        depth = level - start_level           # >= 0 while walking
        root = cur >> depth.clamp(min=0)
        subtree_done = t >= depth
        nxt = torch.where(subtree_done, root + 1, (cur >> t) + 1)
        nxt = torch.where(subtree_done & (root + 1 > last_root), 0, nxt)
        inode = torch.where(descend, 2 * cur, nxt)
        return torch.where(active, inode, 0), counts

    while True:
        for _ in range(BLOCK_STEPS):
            inode, counts = body(inode, counts)
        tracing.count("walk.steps", BLOCK_STEPS)
        if not tracing.to_bool((inode > 0).any(), "walk.end"):
            break
    return counts, out[:capacity]


def _lane_tests(target, lanes, narrow, flip: bool, self_contact: bool,
                ray_offset: int):
    """Node test, leaf test and emitter of ``stackless_walk`` for the lane
    spec (see :func:`route_walk`)."""
    if isinstance(lanes, tuple):          # rays
        points, directions = lanes
        iray = torch.arange(ray_offset + 1,
                            ray_offset + points[0].shape[0] + 1,
                            dtype=target.skips.dtype, device=target.device)

        def node_test(node_vol):
            return isintersection(node_vol, points, directions)

        def leaf_test(leaf):
            hit = isintersection(leaf.volume, points, directions)
            if narrow is not None:
                hit = hit & narrow(leaf, points, directions)
            return hit

        def emit(leaf):
            return torch.stack([leaf.index, iray], dim=-1)

        return node_test, leaf_test, emit

    q = lanes
    q_node_vol = convert_volume(target.node_kind, q.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf):
        hit = iscontact(q.volume, leaf.volume)
        if narrow is not None:
            hit = hit & (narrow(leaf, q) if flip else narrow(q, leaf))
        return hit

    def emit(leaf):
        if self_contact:          # sorted (min, max) user-index pairs
            return torch.stack([torch.minimum(q.index, leaf.index),
                                torch.maximum(q.index, leaf.index)], dim=-1)
        if flip:                  # tree order: (index in bvh1, in bvh2)
            return torch.stack([leaf.index, q.index], dim=-1)
        return torch.stack([q.index, leaf.index], dim=-1)

    return node_test, leaf_test, emit


def walk_lanes_plain(target, start_level: int, lanes, *, flip: bool = False,
                     dedup_ileaf=None, ray_offset: int = 0, narrow=None,
                     capacity: int = 0, offsets=None):
    """:func:`stackless_walk` for the lane spec of :func:`route_walk`: the
    torch-op loop, on any device, with ``narrow`` if given (W1's plain
    version)."""
    num_lanes = lanes[0][0].shape[0] if isinstance(lanes, tuple) \
        else lanes.index.shape[0]
    return stackless_walk(
        target.tree, target.nodes, target.leaves, target.skips, start_level,
        *_lane_tests(target, lanes, narrow, flip, dedup_ileaf is not None,
                     ray_offset),
        num_lanes=num_lanes, dedup_ileaf=dedup_ileaf, capacity=capacity,
        offsets=offsets)


def route_walk(target, start_level: int, lanes, *, flip: bool = False,
               dedup_ileaf=None, ray_offset: int = 0, narrow=None,
               capacity: int = 0, offsets=None):
    """One pass of the walk of ``target`` (a BVH) from ``start_level``;
    returns ``(counts (K,), out (capacity, 2))``.

    The lane spec: ``lanes`` is a ``Leaves`` (leaf volumes and user
    indices) or a ``(points, directions)`` pair of coordinate 3-tuples of
    (K,) ray tensors; ``dedup_ileaf`` ((K,) implicit leaf indices) makes it
    self-contact, with sorted ``(min, max)`` rows and the dedup prune;
    otherwise rows are ``(lane, leaf)``, ``(leaf, lane)`` with ``flip``, or
    ``(leaf, ray_offset + k + 1)`` for rays.  ``narrow`` is called as
    ``narrow(lane, leaf)`` (``narrow(leaf, lane)`` with ``flip``) or
    ``narrow(leaf, points, directions)``.

    On the card with no ``narrow``: kernel W1 (``ops.walk_lanes``, no host
    sync; float32 or float64 volumes).  For CPU tensors, and with
    ``narrow`` on every device: :func:`walk_lanes_plain`, the torch-op
    loop, which syncs with the host once every ``BLOCK_STEPS`` steps (no
    kernel can call a Python callback).  The pass is a ``walk.count`` or
    ``walk.write`` span.
    """
    with tracing.span("walk.write" if capacity > 0 else "walk.count",
                      target.device):
        if narrow is None and cuda_device(target.skips):
            return walk_lanes(target, start_level, lanes, flip=flip,
                              dedup_ileaf=dedup_ileaf,
                              ray_offset=ray_offset, capacity=capacity,
                              offsets=offsets)
        return walk_lanes_plain(target, start_level, lanes, flip=flip,
                                dedup_ileaf=dedup_ileaf,
                                ray_offset=ray_offset, narrow=narrow,
                                capacity=capacity, offsets=offsets)
