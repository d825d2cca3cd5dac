"""Traversal result and algorithm types.

Counterpart of ``implicitbvh_tpu/traverse/types.py:14-90``.
"""

from __future__ import annotations

import dataclasses

import torch


class TraversalAlgorithm:
    """Base marker for traversal algorithm parameter objects."""


@dataclasses.dataclass(frozen=True)
class BFSTraversal(TraversalAlgorithm):
    """Simultaneous breadth-first traversal of the pair tree (self-contact,
    two trees, rays): a frontier of static capacity, compacted level by
    level, grown on overflow (``traverse/bfs.py``)."""


@dataclasses.dataclass(frozen=True)
class DFSTraversal(TraversalAlgorithm):
    """Depth-first traversal of the pair tree, self-contact only
    (``traverse/dfs.py``; the JAX package defines this class there).  As in
    the JAX package, two trees and rays given one take the leaf-vs-tree
    walk (two trees from DFS's deep default start levels)."""


@dataclasses.dataclass(frozen=True)
class LVTTraversal(TraversalAlgorithm):
    """Leaf-vs-tree traversal: the stackless lockstep walk of
    ``traverse/walk.py`` over all leaves (or rays), with the count -> scan
    -> write output scheme.  The default for CPU tensors and for BVHs of
    mixed leaf kinds, and where the tile engine's growth ends."""


@dataclasses.dataclass(frozen=True)
class BVHTraversal:
    """Traversal result.

    ``cache1`` holds the contact pairs as a ``(capacity, 2)`` index tensor;
    ``contacts`` views its first ``num_contacts`` rows.  ``pair_capacity``
    and ``tile_alg`` carry the (possibly growth-enlarged) capacities so a
    repeat traversal with ``cache=`` starts from them.
    """

    num_contacts: int
    cache1: torch.Tensor
    cache2: torch.Tensor
    start_level1: int = 1
    start_level2: int = 0
    num_checks: int = 0
    pair_capacity: int = 0
    tile_alg: object = None

    @property
    def start_level(self) -> int:
        return self.start_level1

    @property
    def contacts(self) -> torch.Tensor:
        return self.cache1[:int(self.num_contacts)]

    def contacts_list(self):
        """Contacts as a list of Python int tuples."""
        return [tuple(int(v) for v in row) for row in self.contacts.tolist()]
