"""Traversal: the tile self-contact engine and its result type."""

from .tiles import TileTraversal, traverse_tiles, traverse_tiles_fixed
from .types import BVHTraversal, TraversalAlgorithm

__all__ = ["BVHTraversal", "TileTraversal", "TraversalAlgorithm",
           "traverse_tiles", "traverse_tiles_fixed"]
