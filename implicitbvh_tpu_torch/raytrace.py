"""Ray queries: batched forward rays against the leaves of a BVH.

Counterpart of ``implicitbvh_tpu/raytrace.py``.  ``traverse_rays`` validates
its input and dispatches to the tile ray engine (``traverse/ray_tiles.py``),
which is what the JAX package's default resolves to on an accelerator.  The
stackless leaf-vs-tree ray walk and the breadth-first variant are not ported:
asking for them raises ``NotImplementedError`` (ROADMAP A11).
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import BVH
from .options import DEFAULT_OPTIONS, BVHOptions
from .traverse.tiles import TileTraversal
from .traverse.types import (BFSTraversal, BVHTraversal, LVTTraversal,
                             TraversalAlgorithm)


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


def traverse_rays_fixed(bvh: BVH, points, directions, capacity: int, *,
                        start_level: int = 1, narrow=None):
    """The fixed-capacity stackless ray walk of the JAX package; not
    ported (ROADMAP A11).  Use
    :func:`~.traverse.ray_tiles.traverse_rays_tiles_fixed`."""
    raise NotImplementedError(
        "the stackless ray walk is not ported (ROADMAP A11); use "
        "traverse_rays_tiles_fixed")


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

    With no ``alg`` the tile engine runs (``TileTraversal()``), as in the
    JAX package on an accelerator.  ``LVTTraversal()`` and
    ``BFSTraversal()`` raise ``NotImplementedError`` (ROADMAP A11).
    """
    if alg is None:
        alg = TileTraversal()
    if not (bvh.built_level <= start_level <= bvh.tree.levels):
        raise ValueError(f"invalid start_level {start_level}")
    p, _ = _prep_rays(points, directions, bvh.leaves.volume.dtype, bvh.device)
    if p[0].shape[0] == 0 or bvh.tree.real_nodes < 1:
        z = torch.zeros((0,), dtype=torch.int32, device=bvh.device)
        return BVHTraversal(num_contacts=0, cache1=z.view(0, 2), cache2=z,
                            start_level1=start_level)
    if isinstance(alg, TileTraversal):
        from .traverse.ray_tiles import traverse_rays_tiles
        # row_cap=4 is the self-contact default; rays want 8
        ralg = alg if alg != TileTraversal() else TileTraversal(row_cap=8)
        return traverse_rays_tiles(bvh, points, directions, alg=ralg,
                                   narrow=narrow, cache=cache,
                                   options=options)
    if isinstance(alg, (LVTTraversal, BFSTraversal)):
        raise NotImplementedError(
            f"{type(alg).__name__} ray traversal (the tree walks) is not "
            "ported (ROADMAP A11); use TileTraversal()")
    raise TypeError(f"unknown traversal algorithm {alg!r}")
