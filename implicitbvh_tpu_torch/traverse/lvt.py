"""Leaf-vs-tree traversal (one BVH, and BVH against BVH).

Counterpart of ``implicitbvh_tpu/traverse/lvt.py``: one lane per leaf walks
the tree with the stackless walk of ``walk.py``, in a count pass, an
exclusive scan of the per-lane counts, and a write pass at those offsets.
On the card with no ``narrow`` the walk is kernel W1, so the ``*_fixed``
functions make no host sync and a CUDA graph captures them, as the JAX
package's jit them; with ``narrow`` the walk is the torch-op loop, which
syncs with the host (``walk.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import tracing
from ..build import BVH, Leaves
from ..options import BVHOptions
from .types import BVHTraversal
from .walk import route_walk


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
    need = max(tracing.to_int(total, "lvt.total"), options.min_capacity)
    if cache is not None and cache.cache1.dim() == 2 \
            and cache.cache1.shape[0] >= need:
        return cache.cache1.shape[0]
    return 1 << math.ceil(math.log2(need))


def _scan(counts):
    """(exclusive prefix sums, total) of the per-lane counts; a
    ``walk.scan`` span."""
    with tracing.span("walk.scan", counts.device):
        incl = torch.cumsum(counts, 0, dtype=counts.dtype)
        return incl - counts, counts.sum(dtype=counts.dtype)


# --------------------------------------------------------------------------
# One BVH: self-contact
# --------------------------------------------------------------------------

def _walk_single(bvh: BVH, start_level: int, narrow, **kw):
    n = bvh.num_leaves
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    dedup = torch.arange(1, n + 1, dtype=bvh.skips.dtype,
                         device=bvh.device) + leaf_base
    return route_walk(bvh, start_level, bvh.leaves, dedup_ileaf=dedup,
                      narrow=narrow, **kw)


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
    user-index pairs.  No host sync on the card unless ``narrow`` is
    given (``walk.py``)."""
    if start_level is None:
        start_level = default_start_level_lvt(bvh)
    counts = lvt_count_single(bvh, start_level, narrow)
    offsets, total = _scan(counts)
    return total, lvt_write_single(bvh, offsets, start_level, capacity,
                                   narrow)


# --------------------------------------------------------------------------
# BVH against BVH
# --------------------------------------------------------------------------

def lvt_count_pair(lanes: Leaves, target: BVH, start_level2: int,
                   narrow=None, flip: bool = False):
    return route_walk(target, start_level2, lanes, flip=flip,
                      narrow=narrow)[0]


def lvt_write_pair(lanes: Leaves, target: BVH, offsets, start_level2: int,
                   capacity: int, narrow=None, flip: bool = False):
    return route_walk(target, start_level2, lanes, flip=flip, narrow=narrow,
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
    tree is walked, and ``narrow`` called in that order too.  No host sync
    on the card unless ``narrow`` is given (``walk.py``)."""
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
