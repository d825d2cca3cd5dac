"""Implicit binary tree index algebra.

Counterpart of ``implicitbvh_tpu/tree.py:38-155``: the whole tree shape
(levels, virtual node counts, per-level offsets, skips) is plain Python
integer math; ``compute_skips`` makes the skip table on the device from
those integers (no host data, so ``build`` makes no host sync), and
``isvirtual_lanes`` and ``memory_index_lanes`` answer the same questions for
tensors of implicit indices (the JAX package's ``*_traced`` helpers).

Nodes are labelled 1-based in BFS order over a perfect binary tree; level 1
is the root and level ``levels`` the leaf level.  Leaves beyond
``real_leaves`` are virtual and never stored; real nodes are stored
contiguously per level, and ``skips`` gives the number of virtual nodes
before each level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import floor_ilog2, ilog2_static, resolve_device


def _popcount(x: int) -> int:
    return bin(x).count("1")


@dataclasses.dataclass(frozen=True)
class ImplicitTree:
    """Static shape of an implicit BVH over ``real_leaves`` elements."""

    levels: int
    real_leaves: int
    real_nodes: int
    virtual_leaves: int
    virtual_nodes: int

    @classmethod
    def from_num_leaves(cls, num_leaves: int) -> "ImplicitTree":
        if num_leaves < 1:
            raise ValueError("must have at least one geometry!")
        lr = int(num_leaves)
        levels = ilog2_static(lr, round_up=True) + 1
        lv = (1 << (levels - 1)) - lr
        nv = 2 * lv - _popcount(lv)
        nr = 2 * lr - 1 + _popcount(lv)
        return cls(levels=levels, real_leaves=lr, real_nodes=nr,
                   virtual_leaves=lv, virtual_nodes=nv)

    def virtual_nodes_before_level(self, level: int) -> int:
        """Number of virtual nodes on the levels strictly above ``level``."""
        vnl = self.virtual_leaves >> (self.levels - (level - 1))
        return 2 * vnl - _popcount(vnl)

    def memory_index(self, implicit_index: int) -> int:
        """Memory index (1-based) of the real node at ``implicit_index``."""
        if not (1 <= implicit_index <= (1 << self.levels) - 1):
            raise IndexError(implicit_index)
        level = ilog2_static(implicit_index) + 1
        return implicit_index - self.virtual_nodes_before_level(level)

    def level_nodes(self, level: int) -> int:
        """Number of real nodes at ``level``."""
        return (1 << (level - 1)) - (self.virtual_leaves >> (self.levels - level))

    def level_indices(self, level: int):
        """(start, stop) 1-based inclusive memory-index range of ``level``."""
        if not (1 <= level <= self.levels):
            raise IndexError(level)
        start = self.memory_index(1 << (level - 1))
        return start, start + self.level_nodes(level) - 1

    def isvirtual(self, implicit_index: int) -> bool:
        if not (1 <= implicit_index <= (1 << self.levels) - 1):
            raise IndexError(implicit_index)
        level = ilog2_static(implicit_index) + 1
        level_first = 1 << (level - 1)
        return implicit_index - level_first + 1 > self.level_nodes(level)

    def skips_np(self, dtype=np.int32) -> np.ndarray:
        """Per-level virtual-node skip counts: ``skips[l - 1]`` equals
        ``virtual_nodes_before_level(l)``."""
        return np.array(
            [self.virtual_nodes_before_level(lv)
             for lv in range(1, self.levels + 1)], dtype=dtype)

    @property
    def num_nodes(self) -> int:
        """Number of stored (non-leaf) real nodes."""
        return self.real_nodes - self.real_leaves


def _popcount_lanes(x: torch.Tensor) -> torch.Tensor:
    """Set bits of every entry of a non-negative int64 tensor (shift and
    mask: pairs, nibbles, bytes, then the byte sum in the top byte)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def compute_skips(tree: ImplicitTree, dtype=torch.int32, device=None):
    """Tensor of per-level skips, ``skips_np``'s values, made on the device
    from the tree's integers (an arange and shifts: nothing is copied from
    the host)."""
    level = torch.arange(1, tree.levels + 1, dtype=torch.int64,
                         device=resolve_device(device))
    vnl = torch.full_like(level, tree.virtual_leaves) >> \
        (tree.levels + 1 - level)
    return (2 * vnl - _popcount_lanes(vnl)).to(dtype)


def isvirtual_lanes(tree: ImplicitTree, implicit_index: torch.Tensor,
                    level=None) -> torch.Tensor:
    """``isvirtual`` of every entry of an integer tensor of implicit
    indices (``level``: their 1-based levels, if already known)."""
    if level is None:
        level = floor_ilog2(implicit_index) + 1
    level_first = torch.ones_like(implicit_index) << (level - 1)
    nreal = level_first - (torch.full_like(implicit_index,
                                           tree.virtual_leaves)
                           >> (tree.levels - level))
    return implicit_index - level_first + 1 > nreal


def memory_index_lanes(tree: ImplicitTree, implicit_index: torch.Tensor,
                       skips: torch.Tensor, level=None) -> torch.Tensor:
    """1-based memory index of every entry of a tensor of real implicit
    indices; ``skips`` is the tensor of :func:`compute_skips`."""
    if level is None:
        level = floor_ilog2(implicit_index) + 1
    return implicit_index - skips[(level - 1).long()].to(implicit_index.dtype)
