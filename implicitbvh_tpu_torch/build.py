"""BVH construction: Morton encode -> stable sort -> aggregate.

Counterpart of ``implicitbvh_tpu/build.py`` (``wrap_bounding_volumes``,
``_sort_by_morton``, the BBox-node aggregation and ``BVH``/``build``).
The work is ``ops.tree_build``: on a CUDA device, for BSphere or BBox
leaves in float32 or float64 under BBox nodes and the default Morton
order, the kernels T1 around one ``torch.sort(stable=True)`` of narrow
keys; otherwise its plain version, the chain of torch ops (the sort on the
int64 key followed by one gather of every leaf field, BBox nodes by a plain
per-level min/max over a perfect tree padded with ``finfo.max`` sentinels,
BSphere nodes by the level-by-level pairwise merge: the sphere merge is not
associative, so it stays tree-structured).  Both keep the JAX package's
stable order for equal codes.

Like the JAX package's build, it makes no host sync for any
``BVHOptions``: the tree's shape is Python integers, the skip table is made
on the device from them, and the Morton bounds and the extended order's
schedule are device tensors.  So a CUDA graph can capture ``build`` with
the traversal after it.
"""

from __future__ import annotations

import builtins
import dataclasses
from typing import Optional, Union

import torch

from . import tracing
from .ops.tree_build import tree_build
from .options import DEFAULT_OPTIONS, BVHOptions
from .tree import ImplicitTree
from .utils import as_tensor
from .volumes import BBox, BSphere, Volume


@dataclasses.dataclass(frozen=True)
class Leaves:
    """Leaf volumes with their user indices and Morton codes (int64)."""

    volume: Volume
    index: torch.Tensor
    morton: torch.Tensor

    def __getitem__(self, idx):
        return Leaves(self.volume[idx], self.index[idx], self.morton[idx])


# the JAX package's (and the reference's) name of the leaf element type
BoundingVolume = Leaves


def wrap_bounding_volumes(volumes: Volume,
                          options: BVHOptions = DEFAULT_OPTIONS,
                          indices=None) -> Leaves:
    """Attach user indices (1-based by default) and zeroed Morton codes."""
    n = volumes.batch_shape[0]
    dev = volumes.device
    if indices is None:
        indices = torch.arange(1, n + 1, dtype=options.index_dtype, device=dev)
    else:
        indices = as_tensor(indices, options.index_dtype, dev)
    return Leaves(volumes, indices, torch.zeros(n, dtype=torch.int64,
                                                device=dev))


def compute_build_level(tree: ImplicitTree, built_level) -> int:
    """Integer or fractional (0..1) built level."""
    if isinstance(built_level, int):
        if not 1 <= built_level <= tree.levels:
            raise ValueError(
                f"built_level {built_level} out of [1, {tree.levels}]")
        return built_level
    if isinstance(built_level, float):
        if not 0.0 <= built_level <= 1.0:
            raise ValueError("fractional built_level must be in [0, 1]")
        # round half to even, like the JAX package
        return int(builtins.round(
            tree.levels + (1 - tree.levels) * built_level))
    raise TypeError(
        f"built_level must be int or float, got {type(built_level)}")


@dataclasses.dataclass(frozen=True)
class BVH:
    """Implicit bounding volume hierarchy.

    - ``skips``: per-level virtual-node skip table
    - ``nodes``: node volumes in memory-index layout
    - ``leaves``: Morton-sorted :class:`Leaves`
    - ``built_level``: level up to which the tree is aggregated
    - ``tree``: the static :class:`ImplicitTree` shape
    """

    skips: torch.Tensor
    nodes: Volume
    leaves: Leaves
    built_level: int
    tree: ImplicitTree

    @property
    def num_leaves(self) -> int:
        return self.tree.real_leaves

    @property
    def device(self):
        return self.leaves.index.device

    @property
    def node_kind(self):
        return BSphere if isinstance(self.nodes, BSphere) else BBox

    @property
    def leaf_kind(self):
        return BSphere if isinstance(self.leaves.volume, BSphere) else BBox


def build(bounding_volumes: Union[Volume, Leaves], node_kind=BBox, *,
          built_level: Union[int, float] = 1,
          options: BVHOptions = DEFAULT_OPTIONS,
          indices: Optional[torch.Tensor] = None) -> BVH:
    """Build a BVH over a batch of :class:`BSphere`/:class:`BBox` leaves
    (or pre-wrapped :class:`Leaves` carrying custom user indices), with
    nodes of ``node_kind`` (BBox, or BSphere over sphere leaves).  Runs on
    the leaves' device."""
    if isinstance(bounding_volumes, Leaves):
        device = bounding_volumes.volume.device
    else:
        device = bounding_volumes.device
    tracing.count("calls.build")
    with tracing.span("build", device):
        return _build(bounding_volumes, node_kind, built_level, options,
                      indices)


def _build(bounding_volumes, node_kind, built_level, options, indices) -> BVH:
    if isinstance(bounding_volumes, Leaves):
        volume = bounding_volumes.volume
        indices = bounding_volumes.index
    else:
        volume = bounding_volumes
    if indices is not None:
        indices = as_tensor(indices, options.index_dtype, volume.device)
    n = volume.batch_shape[0] if indices is None else indices.shape[0]
    tree = ImplicitTree.from_num_leaves(n)
    built_ilevel = compute_build_level(tree, built_level)
    leaves, index, morton, nodes, skips = tree_build(
        volume, indices, tree, built_ilevel, node_kind, options)
    return BVH(skips=skips, nodes=nodes, leaves=Leaves(leaves, index, morton),
               built_level=built_ilevel, tree=tree)
