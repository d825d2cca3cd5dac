"""Public traversal API: ``traverse`` with algorithm dispatch and the
capacity-managing host wrapper.

Counterpart of ``implicitbvh_tpu/traverse/api.py``.  ``traverse(bvh)`` is
self-contact and ``traverse(bvh1, bvh2)`` two-tree contact; an algorithm
object among the positional arguments picks the engine.  For pipelines
with a fixed capacity use the ``*_fixed`` functions.
"""

from __future__ import annotations

import warnings
from typing import Optional

from .. import tracing
from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from . import lvt as _lvt
from .bfs import traverse_bfs_pair, traverse_bfs_single
from .dfs import traverse_dfs_single
from .tiles import TileTraversal, traverse_tiles, traverse_tiles_pair
from .types import (BFSTraversal, BVHTraversal, DFSTraversal, LVTTraversal,
                    TraversalAlgorithm)


def default_start_level(bvh: BVH,
                        alg: TraversalAlgorithm = LVTTraversal()) -> int:
    """BFS and DFS seed their frontier deep (half the levels); the
    leaf-vs-tree walk starts at the built level."""
    if isinstance(alg, (BFSTraversal, DFSTraversal)):
        return max(bvh.tree.levels // 2, bvh.built_level)
    return max(1, bvh.built_level)


def _default_algorithm(*bvhs: BVH) -> TraversalAlgorithm:
    """The tile engine for BVHs on a CUDA device whose leaves are of one
    kind; the leaf-vs-tree walk for CPU tensors (no kernel to launch) and
    for mixed leaf kinds (the tile kernels take one)."""
    if all(b.device.type == "cuda" for b in bvhs) and \
            len({b.leaf_kind for b in bvhs}) == 1:
        return TileTraversal()
    return LVTTraversal()


def _finish(total, out, offsets, start_level1, start_level2=0, num_checks=0):
    return BVHTraversal(
        num_contacts=total, cache1=out, cache2=offsets,
        start_level1=start_level1, start_level2=start_level2,
        num_checks=num_checks)


def _warn_start_level(names: str, stacklevel: int):
    warnings.warn(
        f"{names} has no effect on the tile engine (it does not walk the "
        "tree); use LVTTraversal() for start-level control", UserWarning,
        stacklevel=stacklevel + 1)


def traverse(bvh: BVH, *args,
             start_level: Optional[int] = None,
             start_level1: Optional[int] = None,
             start_level2: Optional[int] = None,
             narrow=None,
             cache: Optional[BVHTraversal] = None,
             options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Contact detection: ``traverse(bvh)`` for self-contact or
    ``traverse(bvh1, bvh2)`` for two-tree contact, with an optional
    algorithm among the positional arguments (``TileTraversal()``,
    ``LVTTraversal()``, ``BFSTraversal()`` or, for self-contact,
    ``DFSTraversal()``; the default follows the device, see
    :func:`_default_algorithm`).

    Returns a :class:`BVHTraversal` whose ``contacts`` are 1-based
    user-index pairs: sorted ``(min, max)`` for self-contact, tree order
    ``(index in bvh1, index in bvh2)`` for two trees.  It runs on the BVHs'
    device.

    The start levels seed the tree-walking algorithms (LVT, BFS, DFS).  The
    tile engine walks no tree, so giving it one emits a ``UserWarning``.
    """
    tracing.count("calls.traverse")
    with tracing.span("traverse", bvh.device):
        return _traverse(bvh, *args, start_level=start_level,
                         start_level1=start_level1,
                         start_level2=start_level2, narrow=narrow,
                         cache=cache, options=options)


def _traverse(bvh: BVH, *args, start_level=None, start_level1=None,
              start_level2=None, narrow=None, cache=None,
              options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """:func:`traverse` with no span and no count: the tile engine's growth
    ends here, inside the call that counted."""
    bvh2: Optional[BVH] = None
    alg: Optional[TraversalAlgorithm] = None
    for a in args:
        if isinstance(a, BVH):
            bvh2 = a
        elif isinstance(a, TraversalAlgorithm):
            alg = a
        else:
            raise TypeError(f"unexpected positional argument {a!r}")
    if alg is None:
        alg = _default_algorithm(*([bvh] if bvh2 is None else [bvh, bvh2]))

    if bvh2 is not None:
        return _traverse_pair(bvh, bvh2, alg, start_level1=start_level1,
                              start_level2=start_level2, narrow=narrow,
                              cache=cache, options=options)

    explicit_start = start_level is not None
    if start_level is None:
        start_level = default_start_level(bvh, alg)
    if not (bvh.built_level <= start_level <= bvh.tree.levels):
        raise ValueError(
            f"need built_level <= start_level <= levels, got {start_level}")

    if bvh.tree.real_nodes <= 1:
        return _lvt._empty_traversal(bvh, start_level)
    if isinstance(alg, BFSTraversal):
        return traverse_bfs_single(bvh, start_level=start_level,
                                   narrow=narrow, cache=cache,
                                   options=options)
    if isinstance(alg, DFSTraversal):
        return traverse_dfs_single(bvh, start_level=start_level,
                                   narrow=narrow, cache=cache,
                                   options=options)
    if isinstance(alg, TileTraversal):
        if explicit_start:
            _warn_start_level("start_level", 3)
        return traverse_tiles(bvh, alg=alg, narrow=narrow, cache=cache,
                              options=options)
    if not isinstance(alg, LVTTraversal):
        raise TypeError(f"unknown traversal algorithm {alg!r}")

    counts = _lvt.lvt_count_single(bvh, start_level, narrow)
    offsets, total = _lvt._scan(counts)
    total = tracing.to_int(total, "api.total")
    capacity = _lvt._round_capacity(total, options, cache)
    out = _lvt.lvt_write_single(bvh, offsets, start_level, capacity, narrow)
    return _finish(total, out, offsets, start_level)


def _traverse_pair(bvh1: BVH, bvh2: BVH, alg: TraversalAlgorithm, *,
                   start_level1, start_level2, narrow, cache, options):
    explicit_start = start_level1 is not None or start_level2 is not None
    if start_level1 is None:
        start_level1 = default_start_level(bvh1, alg)
    if start_level2 is None:
        start_level2 = default_start_level(bvh2, alg)
    for b, sl in ((bvh1, start_level1), (bvh2, start_level2)):
        if not (b.built_level <= sl <= b.tree.levels):
            raise ValueError(f"invalid start level {sl}")

    if isinstance(alg, TileTraversal):
        if explicit_start:
            _warn_start_level("start_level1/start_level2", 4)
        return traverse_tiles_pair(bvh1, bvh2, alg=alg, narrow=narrow,
                                   cache=cache, options=options)
    if isinstance(alg, BFSTraversal):
        return traverse_bfs_pair(bvh1, bvh2, start_level1=start_level1,
                                 start_level2=start_level2, narrow=narrow,
                                 cache=cache, options=options)
    # DFS is self-contact only: two trees take the leaf-vs-tree walk from
    # DFS's deep default start levels, as in the JAX package
    if not isinstance(alg, (LVTTraversal, DFSTraversal)):
        raise TypeError(f"unknown traversal algorithm {alg!r}")

    lanes, target, sl, flip = _lvt._lanes_and_target(
        bvh1, bvh2, start_level1, start_level2)
    counts = _lvt.lvt_count_pair(lanes, target, sl, narrow, flip)
    offsets, total = _lvt._scan(counts)
    total = tracing.to_int(total, "api.total")
    capacity = _lvt._round_capacity(total, options, cache)
    out = _lvt.lvt_write_pair(lanes, target, offsets, sl, capacity, narrow,
                              flip)
    return _finish(total, out, offsets, start_level1, start_level2)
