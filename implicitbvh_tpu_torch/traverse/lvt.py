"""Leaf-vs-tree traversal (one BVH, and BVH against BVH).

Counterpart of ``implicitbvh_tpu/traverse/lvt.py``: one lane per leaf walks
the tree with the stackless walk of ``walk.py`` (torch ops, no kernel), in
a count pass, an exclusive scan of the per-lane counts, and a write pass at
those offsets.  Unlike the JAX package's, the ``*_fixed`` functions here
sync with the host to end the walk's loop (see ``walk.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..build import BVH, Leaves
from ..options import BVHOptions
from ..volumes import convert_volume, iscontact
from .types import BVHTraversal
from .walk import stackless_walk


def default_start_level_lvt(bvh: BVH) -> int:
    return max(1, bvh.built_level)


def _empty_traversal(bvh: BVH, start_level: int, start_level2: int = 0):
    z = torch.zeros((0,), dtype=bvh.skips.dtype, device=bvh.device)
    return BVHTraversal(num_contacts=0, cache1=z.view(0, 2), cache2=z,
                        start_level1=start_level, start_level2=start_level2)


def _round_capacity(total: int, options: BVHOptions,
                    cache: Optional[BVHTraversal] = None) -> int:
    """Round a required size up to a power of two; a previous result's
    capacity is taken as it is when it has the room."""
    need = max(int(total), options.min_capacity)
    if cache is not None and cache.cache1.dim() == 2 \
            and cache.cache1.shape[0] >= need:
        return cache.cache1.shape[0]
    return 1 << math.ceil(math.log2(need))


def _scan(counts):
    """(exclusive prefix sums, total) of the per-lane counts."""
    incl = torch.cumsum(counts, 0, dtype=counts.dtype)
    return incl - counts, counts.sum(dtype=counts.dtype)


# --------------------------------------------------------------------------
# One BVH: self-contact
# --------------------------------------------------------------------------

def _single_closures(bvh: BVH, narrow, lanes: Optional[Leaves] = None):
    """Node test, leaf test and emitter for the leaf lanes ``lanes`` (all
    N leaves by default)."""
    q = bvh.leaves if lanes is None else lanes
    q_node_vol = convert_volume(bvh.node_kind, q.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf: Leaves):
        hit = iscontact(q.volume, leaf.volume)
        if narrow is not None:
            hit = hit & narrow(q, leaf)
        return hit

    def emit(leaf: Leaves):       # sorted (min, max) user-index pairs
        return torch.stack([torch.minimum(q.index, leaf.index),
                            torch.maximum(q.index, leaf.index)], dim=-1)

    return node_test, leaf_test, emit


def _walk_single(bvh: BVH, start_level: int, narrow, **kw):
    n = bvh.num_leaves
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    dedup = torch.arange(1, n + 1, dtype=bvh.skips.dtype,
                         device=bvh.device) + leaf_base
    return stackless_walk(
        bvh.tree, bvh.nodes, bvh.leaves, bvh.skips, start_level,
        *_single_closures(bvh, narrow), num_lanes=n, dedup_ileaf=dedup, **kw)


def lvt_count_single(bvh: BVH, start_level: int, narrow=None):
    """Counting pass: per-lane contact counts (N,)."""
    return _walk_single(bvh, start_level, narrow)[0]


def lvt_write_single(bvh: BVH, offsets, start_level: int, capacity: int,
                     narrow=None):
    """Writing pass at per-lane offsets: the (capacity, 2) contact list."""
    return _walk_single(bvh, start_level, narrow, capacity=capacity,
                        offsets=offsets)[1]


def traverse_lvt_single_fixed(bvh: BVH, capacity: int, *,
                              start_level: Optional[int] = None, narrow=None):
    """Fixed-capacity LVT self-contact traversal.

    Returns ``(total, contacts)`` as tensors on the BVH's device; the first
    ``min(total, capacity)`` rows of ``contacts`` hold sorted ``(min, max)``
    user-index pairs.  The walk's loop syncs with the host."""
    if start_level is None:
        start_level = default_start_level_lvt(bvh)
    counts = lvt_count_single(bvh, start_level, narrow)
    offsets, total = _scan(counts)
    return total, lvt_write_single(bvh, offsets, start_level, capacity,
                                   narrow)


# --------------------------------------------------------------------------
# BVH against BVH
# --------------------------------------------------------------------------

def _pair_closures(lanes: Leaves, target: BVH, narrow, flip: bool):
    q = lanes
    q_node_vol = convert_volume(target.node_kind, q.volume)

    def node_test(node_vol):
        return iscontact(q_node_vol, node_vol)

    def leaf_test(leaf: Leaves):
        hit = iscontact(q.volume, leaf.volume)
        if narrow is not None:
            hit = hit & (narrow(leaf, q) if flip else narrow(q, leaf))
        return hit

    def emit(leaf: Leaves):       # tree order (index in bvh1, index in bvh2)
        if flip:
            return torch.stack([leaf.index, q.index], dim=-1)
        return torch.stack([q.index, leaf.index], dim=-1)

    return node_test, leaf_test, emit


def _walk_pair(lanes: Leaves, target: BVH, start_level2: int, narrow, flip,
               **kw):
    return stackless_walk(
        target.tree, target.nodes, target.leaves, target.skips, start_level2,
        *_pair_closures(lanes, target, narrow, flip),
        num_lanes=lanes.index.shape[0], **kw)


def lvt_count_pair(lanes: Leaves, target: BVH, start_level2: int,
                   narrow=None, flip: bool = False):
    return _walk_pair(lanes, target, start_level2, narrow, flip)[0]


def lvt_write_pair(lanes: Leaves, target: BVH, offsets, start_level2: int,
                   capacity: int, narrow=None, flip: bool = False):
    return _walk_pair(lanes, target, start_level2, narrow, flip,
                      capacity=capacity, offsets=offsets)[1]


def _lanes_and_target(bvh1: BVH, bvh2: BVH, start_level1: int,
                      start_level2: int):
    """The BVH with more leaves supplies the lanes and the other tree is
    walked; ``flip`` says that the lanes are bvh2's.  Returns ``(lanes,
    target, the target's start level, flip)``."""
    if bvh1.num_leaves >= bvh2.num_leaves:
        return bvh1.leaves, bvh2, start_level2, False
    return bvh2.leaves, bvh1, start_level1, True


def traverse_lvt_pair_fixed(bvh1: BVH, bvh2: BVH, capacity: int, *,
                            start_level1: Optional[int] = None,
                            start_level2: Optional[int] = None,
                            narrow=None):
    """Fixed-capacity LVT pair traversal; returns ``(total, contacts)``,
    contacts in tree order ``(index in bvh1, index in bvh2)`` whichever
    tree is walked, and ``narrow`` called in that order too.  The walk's
    loop syncs with the host."""
    if start_level1 is None:
        start_level1 = default_start_level_lvt(bvh1)
    if start_level2 is None:
        start_level2 = default_start_level_lvt(bvh2)
    lanes, target, sl, flip = _lanes_and_target(bvh1, bvh2, start_level1,
                                                start_level2)
    counts = lvt_count_pair(lanes, target, sl, narrow, flip)
    offsets, total = _scan(counts)
    return total, lvt_write_pair(lanes, target, offsets, sl, capacity,
                                 narrow, flip)
