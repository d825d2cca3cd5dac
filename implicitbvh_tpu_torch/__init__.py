"""implicitbvh_tpu_torch — the implicit BVH engine in PyTorch, with
hand-written CUDA kernels for the H100.

A port of ``implicitbvh_tpu`` (the JAX package, kept as the reference).
Entry points run on CUDA unless the caller passes CPU tensors or
``device="cpu"``; on CPU tensors every kernel runs its plain PyTorch
version.  Ported: triangles -> bounding spheres or boxes -> ``build`` (BBox
or BSphere nodes) -> ``traverse(bvh)`` self-contact, ``traverse(bvh1,
bvh2)`` two-tree contact and ``traverse_rays`` batch ray queries, each
through the tile engine (both routes), the leaf-vs-tree walk or
breadth-first traversal, and self-contact also depth-first; with 32- or
64-bit user indices and the default or the extended Morton order.
"""

from .build import (BVH, BoundingVolume, Leaves, build, compute_build_level,
                    wrap_bounding_volumes)
from .morton import (DefaultMortonAlgorithm, ExtendedMortonAlgorithm,
                     MortonAlgorithm, bounding_volumes_extrema,
                     morton_encode, morton_encode_extended,
                     morton_encode_single, morton_split3)
from .options import DEFAULT_OPTIONS, BVHOptions
from .raytrace import traverse_rays, traverse_rays_fixed
from .traverse import (BFSTraversal, BVHTraversal, DFSTraversal,
                       LVTTraversal, TileTraversal, TraversalAlgorithm,
                       default_start_level, traverse,
                       traverse_lvt_pair_fixed,
                       traverse_lvt_single_fixed, traverse_rays_tiles,
                       traverse_rays_tiles_fixed, traverse_tiles,
                       traverse_tiles_fixed, traverse_tiles_pair,
                       traverse_tiles_pair_fixed)
from .tree import ImplicitTree, compute_skips
from .volumes import (BBox, BSphere, bbox_from_triangles,
                      bsphere_from_triangles, center, from_triangles,
                      iscontact, isintersection, merge)

__all__ = [
    "BBox", "BFSTraversal", "BSphere", "BVH", "BVHOptions", "BVHTraversal",
    "BoundingVolume", "DEFAULT_OPTIONS", "DFSTraversal",
    "DefaultMortonAlgorithm", "ExtendedMortonAlgorithm", "ImplicitTree",
    "LVTTraversal", "Leaves", "MortonAlgorithm", "TileTraversal", "TraversalAlgorithm",
    "bbox_from_triangles", "bounding_volumes_extrema",
    "bsphere_from_triangles", "build", "center", "compute_build_level",
    "compute_skips", "default_start_level", "from_triangles", "iscontact",
    "isintersection", "merge", "morton_encode", "morton_encode_extended",
    "morton_encode_single", "morton_split3", "traverse",
    "traverse_lvt_pair_fixed",
    "traverse_lvt_single_fixed", "traverse_rays", "traverse_rays_fixed",
    "traverse_rays_tiles", "traverse_rays_tiles_fixed", "traverse_tiles",
    "traverse_tiles_fixed", "traverse_tiles_pair",
    "traverse_tiles_pair_fixed", "wrap_bounding_volumes",
]
