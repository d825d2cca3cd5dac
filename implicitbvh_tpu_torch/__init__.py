"""implicitbvh_tpu_torch — the implicit BVH engine in PyTorch, with
hand-written CUDA kernels for the H100.

A port of ``implicitbvh_tpu`` (the JAX package, kept as the reference).
Entry points run on CUDA unless the caller passes CPU tensors or
``device="cpu"``; on CPU tensors every kernel runs its plain PyTorch
version.  Ported so far: triangles -> bounding spheres -> ``build`` (BBox
nodes) -> ``traverse_tiles`` self-contact on the two-phase route.
"""

from .build import BVH, Leaves, build, wrap_bounding_volumes
from .options import DEFAULT_OPTIONS, BVHOptions
from .traverse import (BVHTraversal, TileTraversal, TraversalAlgorithm,
                       traverse_tiles, traverse_tiles_fixed)
from .volumes import BBox, BSphere, bsphere_from_triangles

__all__ = [
    "BBox", "BSphere", "BVH", "BVHOptions", "BVHTraversal",
    "DEFAULT_OPTIONS", "Leaves", "TileTraversal", "TraversalAlgorithm",
    "bsphere_from_triangles", "build", "traverse_tiles",
    "traverse_tiles_fixed", "wrap_bounding_volumes",
]
