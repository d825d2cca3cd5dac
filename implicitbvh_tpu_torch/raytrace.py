"""Ray queries: batched forward rays against the leaves of a BVH.

Counterpart of ``implicitbvh_tpu/raytrace.py``.  ``traverse_rays`` validates
its input and dispatches to the tile ray engine (``traverse/ray_tiles.py``,
the default) or, with ``LVTTraversal()``, to the stackless leaf-vs-tree
walk of ``traverse/walk.py`` with one lane per ray and ``isintersection``
as the test (kernel W1 on the card, no host sync; the torch-op loop, which
syncs with the host, for CPU tensors or a ``narrow`` callback);
``DFSTraversal()`` takes the same walk, as in the JAX package; with
``BFSTraversal()`` the node-ray frontier of ``traverse/bfs.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import tracing
from .build import BVH
from .options import DEFAULT_OPTIONS, BVHOptions
from .traverse.bfs import traverse_rays_bfs
from .traverse.lvt import _empty_traversal, _round_capacity, _scan
from .traverse.tiles import TileTraversal
from .traverse.types import (BFSTraversal, BVHTraversal, DFSTraversal,
                             LVTTraversal, TraversalAlgorithm)
from .traverse.walk import route_walk


def _prep_rays(points, directions, dtype, device):
    """Validate (3, N) ray matrices and split them into coordinate tuples
    of (N,) tensors on ``device``."""
    points = torch.as_tensor(points, dtype=dtype, device=device)
    directions = torch.as_tensor(directions, dtype=dtype, device=device)
    if points.dim() != 2 or points.shape[0] != 3:
        raise ValueError(f"points must be (3, N), got {tuple(points.shape)}")
    if directions.shape != points.shape:
        raise ValueError("points and directions must have the same shape")
    return tuple(points), tuple(directions)


def _walk_rays(bvh: BVH, points, directions, start_level: int, narrow,
               ray_offset: int = 0, **kw):
    """The ray walk: ``points`` and ``directions`` are coordinate tuples of
    (K,) lane tensors, whose 1-based ray indices start at ``ray_offset +
    1``."""
    return route_walk(bvh, start_level, (points, directions),
                      ray_offset=ray_offset, narrow=narrow, **kw)


def rays_count(bvh: BVH, points, directions, start_level: int, narrow=None):
    """Counting pass of the ray walk: per-ray hit counts (K,)."""
    return _walk_rays(bvh, points, directions, start_level, narrow)[0]


def rays_write(bvh: BVH, points, directions, offsets, start_level: int,
               capacity: int, narrow=None):
    """Writing pass of the ray walk at per-ray offsets."""
    return _walk_rays(bvh, points, directions, start_level, narrow,
                      capacity=capacity, offsets=offsets)[1]


def traverse_rays_fixed(bvh: BVH, points, directions, capacity: int, *,
                        start_level: int = 1, narrow=None):
    """Fixed-capacity stackless ray walk; returns ``(total, contacts)`` as
    tensors on the BVH's device, contacts ``(leaf user index, 1-based ray
    index)`` ray by ray.  ``points``/``directions`` are (3, N).  No host
    sync on the card unless ``narrow`` is given (``traverse/walk.py``);
    the tile engine's fixed path is
    :func:`~.traverse.ray_tiles.traverse_rays_tiles_fixed`."""
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype, bvh.device)
    counts = rays_count(bvh, p, d, start_level, narrow)
    offsets, total = _scan(counts)
    return total, rays_write(bvh, p, d, offsets, start_level, capacity,
                             narrow)


def traverse_rays(bvh: BVH, points, directions,
                  alg: Optional[TraversalAlgorithm] = None, *,
                  start_level: int = 1, narrow=None,
                  cache: Optional[BVHTraversal] = None,
                  options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """Intersections of N forward rays with the BVH's leaves.

    ``points``/``directions`` have shape (3, N); they are moved to the BVH's
    device.  Returns a :class:`BVHTraversal` whose contacts are ``(leaf user
    index, ray index)`` pairs with 1-based ray indices, in no particular
    order.  ``narrow(leaves, p, d)`` is an optional vectorised narrow-phase
    predicate.

    With no ``alg`` the tile engine runs (``TileTraversal()``), on every
    device.  ``LVTTraversal()`` takes the stackless walk from
    ``start_level``, with a capacity of the hit count rounded up to a power
    of two (or ``cache``'s when it has the room); ``DFSTraversal()`` takes
    the same walk from ``start_level`` (the ray path has no DFS default);
    ``BFSTraversal()`` takes the breadth-first node-ray frontier from
    ``start_level``, with capacity growth.
    """
    tracing.count("calls.traverse")
    with tracing.span("traverse", bvh.device):
        return _traverse_rays(bvh, points, directions, alg,
                              start_level=start_level, narrow=narrow,
                              cache=cache, options=options)


def _traverse_rays(bvh: BVH, points, directions,
                   alg: Optional[TraversalAlgorithm] = None, *,
                   start_level: int = 1, narrow=None,
                   cache: Optional[BVHTraversal] = None,
                   options: BVHOptions = DEFAULT_OPTIONS) -> BVHTraversal:
    """:func:`traverse_rays` with no span and no count: the tile engine's
    growth ends here, inside the call that counted."""
    if alg is None:
        alg = TileTraversal()
    if not (bvh.built_level <= start_level <= bvh.tree.levels):
        raise ValueError(f"invalid start_level {start_level}")
    p, d = _prep_rays(points, directions, bvh.leaves.volume.dtype, bvh.device)
    if p[0].shape[0] == 0 or bvh.tree.real_nodes < 1:
        return _empty_traversal(bvh, start_level)
    if isinstance(alg, BFSTraversal):
        return traverse_rays_bfs(bvh, p, d, start_level=start_level,
                                 narrow=narrow, options=options)
    if isinstance(alg, TileTraversal):
        from .traverse.ray_tiles import traverse_rays_tiles
        # row_cap=4 is the self-contact default; rays want 8
        ralg = alg if alg != TileTraversal() else TileTraversal(row_cap=8)
        return traverse_rays_tiles(bvh, points, directions, alg=ralg,
                                   narrow=narrow, cache=cache,
                                   options=options)
    if not isinstance(alg, (LVTTraversal, DFSTraversal)):
        raise TypeError(f"unknown traversal algorithm {alg!r}")
    counts = rays_count(bvh, p, d, start_level, narrow)
    offsets, total = _scan(counts)
    total = tracing.to_int(total, "rays.total")
    capacity = _round_capacity(total, options, cache)
    out = rays_write(bvh, p, d, offsets, start_level, capacity, narrow)
    return BVHTraversal(num_contacts=total, cache1=out, cache2=offsets,
                        start_level1=start_level)
