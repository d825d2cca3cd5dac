"""Traversal: the public ``traverse`` dispatch, the tile engines
(self-contact, two trees, rays), the leaf-vs-tree walks, breadth-first
traversal (``bfs.py``), depth-first self-contact (``dfs.py``) and their
result type."""

from .api import default_start_level, traverse
from .dfs import dfs_single_fixed, traverse_dfs_single
from .lvt import (lvt_count_pair, lvt_count_single, lvt_write_pair,
                  lvt_write_single, traverse_lvt_pair_fixed,
                  traverse_lvt_single_fixed)
from .ray_tiles import traverse_rays_tiles, traverse_rays_tiles_fixed
from .tiles import (TileTraversal, traverse_tiles, traverse_tiles_fixed,
                    traverse_tiles_pair, traverse_tiles_pair_fixed)
from .types import (BFSTraversal, BVHTraversal, DFSTraversal, LVTTraversal,
                    TraversalAlgorithm)

__all__ = ["BFSTraversal", "BVHTraversal", "DFSTraversal", "LVTTraversal",
           "TileTraversal", "TraversalAlgorithm", "default_start_level",
           "dfs_single_fixed",
           "lvt_count_pair", "lvt_count_single", "lvt_write_pair",
           "lvt_write_single", "traverse", "traverse_lvt_pair_fixed",
           "traverse_lvt_single_fixed", "traverse_rays_tiles",
           "traverse_rays_tiles_fixed", "traverse_tiles",
           "traverse_dfs_single", "traverse_tiles_fixed",
           "traverse_tiles_pair", "traverse_tiles_pair_fixed"]
