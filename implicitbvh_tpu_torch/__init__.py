"""implicitbvh_tpu_torch — the implicit BVH engine in PyTorch, with
hand-written CUDA kernels for the H100.

A port of ``implicitbvh_tpu`` (the JAX package, kept as the reference).
Entry points run on CUDA unless the caller passes CPU tensors or
``device="cpu"``; on CPU tensors every kernel runs its plain PyTorch
version.  Ported so far: triangles -> bounding spheres -> ``build`` (BBox
nodes) -> ``traverse_tiles`` self-contact (both tile routes) and
``traverse_rays`` batch ray queries through the tile ray engine.
"""

from .build import BVH, Leaves, build, wrap_bounding_volumes
from .options import DEFAULT_OPTIONS, BVHOptions
from .raytrace import traverse_rays
from .traverse import (BFSTraversal, BVHTraversal, LVTTraversal,
                       TileTraversal, TraversalAlgorithm,
                       traverse_rays_tiles, traverse_rays_tiles_fixed,
                       traverse_tiles, traverse_tiles_fixed)
from .volumes import BBox, BSphere, bsphere_from_triangles, isintersection

__all__ = [
    "BBox", "BFSTraversal", "BSphere", "BVH", "BVHOptions", "BVHTraversal",
    "DEFAULT_OPTIONS", "LVTTraversal", "Leaves", "TileTraversal",
    "TraversalAlgorithm", "bsphere_from_triangles", "build",
    "isintersection", "traverse_rays", "traverse_rays_tiles",
    "traverse_rays_tiles_fixed", "traverse_tiles", "traverse_tiles_fixed",
    "wrap_bounding_volumes",
]
