"""implicitbvh_tpu_torch — the implicit BVH engine in PyTorch, with
hand-written CUDA kernels for the H100.

A port of ``implicitbvh_tpu`` (the JAX package, kept as the reference).
Entry points run on CUDA unless the caller passes CPU tensors or
``device="cpu"``; on CPU tensors every kernel runs its plain PyTorch
version.  Ported: triangles -> bounding spheres or boxes -> ``build`` (BBox
or BSphere nodes) -> ``traverse(bvh)`` self-contact, ``traverse(bvh1,
bvh2)`` two-tree contact and ``traverse_rays`` batch ray queries, each
through the tile engine (both routes) or the leaf-vs-tree walk.  BFS and
DFS traversal, 64-bit indices and the extended Morton order are not.
"""

from .build import BVH, Leaves, build, wrap_bounding_volumes
from .options import DEFAULT_OPTIONS, BVHOptions
from .raytrace import traverse_rays, traverse_rays_fixed
from .traverse import (BFSTraversal, BVHTraversal, DFSTraversal,
                       LVTTraversal, TileTraversal, TraversalAlgorithm,
                       traverse, traverse_lvt_pair_fixed,
                       traverse_lvt_single_fixed, traverse_rays_tiles,
                       traverse_rays_tiles_fixed, traverse_tiles,
                       traverse_tiles_fixed, traverse_tiles_pair,
                       traverse_tiles_pair_fixed)
from .volumes import (BBox, BSphere, bbox_from_triangles,
                      bsphere_from_triangles, iscontact, isintersection,
                      merge)

__all__ = [
    "BBox", "BFSTraversal", "BSphere", "BVH", "BVHOptions", "BVHTraversal",
    "DEFAULT_OPTIONS", "DFSTraversal", "LVTTraversal", "Leaves",
    "TileTraversal", "TraversalAlgorithm", "bbox_from_triangles",
    "bsphere_from_triangles", "build", "iscontact", "isintersection",
    "merge", "traverse", "traverse_lvt_pair_fixed",
    "traverse_lvt_single_fixed", "traverse_rays", "traverse_rays_fixed",
    "traverse_rays_tiles", "traverse_rays_tiles_fixed", "traverse_tiles",
    "traverse_tiles_fixed", "traverse_tiles_pair",
    "traverse_tiles_pair_fixed", "wrap_bounding_volumes",
]
