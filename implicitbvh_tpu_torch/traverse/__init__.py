"""Traversal: the tile engines (self-contact and rays) and their result
type."""

from .ray_tiles import traverse_rays_tiles, traverse_rays_tiles_fixed
from .tiles import TileTraversal, traverse_tiles, traverse_tiles_fixed
from .types import (BFSTraversal, BVHTraversal, LVTTraversal,
                    TraversalAlgorithm)

__all__ = ["BFSTraversal", "BVHTraversal", "LVTTraversal", "TileTraversal",
           "TraversalAlgorithm", "traverse_rays_tiles",
           "traverse_rays_tiles_fixed", "traverse_tiles",
           "traverse_tiles_fixed"]
