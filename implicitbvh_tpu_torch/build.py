"""BVH construction: wrap -> Morton encode -> stable sort -> aggregate.

Counterpart of ``implicitbvh_tpu/build.py`` (``wrap_bounding_volumes``,
``_sort_by_morton``, the BBox-node aggregation and ``BVH``/``build``).
The sort is ``torch.sort(stable=True)`` on the Morton key followed by one
gather of every leaf field, which keeps the JAX package's stable order for
equal codes.  BBox nodes are a plain per-level min/max over a perfect tree
padded with ``finfo.max`` sentinels.  BSphere nodes take the level-by-level
pairwise merge: the sphere merge is not associative, so it stays
tree-structured.

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
from .morton import (DefaultMortonAlgorithm, ExtendedMortonAlgorithm,
                     morton_encode, morton_encode_extended)
from .options import DEFAULT_OPTIONS, BVHOptions
from .tree import ImplicitTree, compute_skips
from .utils import as_tensor
from .volumes import (BBox, BSphere, Volume, bbox_of_bsphere, center_coords,
                      convert_volume, merge, merge_into)


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


def _sort_by_morton(leaves: Leaves) -> Leaves:
    """Stable sort of every leaf field along the Z-curve.  The codes are
    unsigned bit patterns in int64 (a 64-bit extended code may set bit
    63): flipping the sign bit maps their unsigned order to int64's."""
    perm = torch.sort(leaves.morton ^ (-1 << 63), stable=True).indices
    return leaves[perm]


def _aggregate_bbox(leaves_vol: Volume, tree: ImplicitTree,
                    built_level: int) -> BBox:
    """BBox nodes in memory-index order (level 1 first): per-level pairwise
    min/max over the perfect tree.  The ``finfo.max`` padding is neutral
    for min/max and reproduces the copy of a lone left child.  Levels above
    ``built_level`` are zero-filled."""
    dtype, dev = leaves_vol.dtype, leaves_vol.device
    levels = tree.levels
    if levels < 2 or tree.real_nodes < 2:
        z = torch.zeros(max(tree.num_nodes, 0), dtype=dtype, device=dev)
        return BBox((z, z, z), (z, z, z))
    box = leaves_vol if isinstance(leaves_vol, BBox) \
        else bbox_of_bsphere(leaves_vol)
    big = torch.finfo(dtype).max
    pad = (1 << (levels - 1)) - tree.real_leaves
    lo = torch.nn.functional.pad(torch.stack(box.los), (0, pad), value=big)
    up = torch.nn.functional.pad(torch.stack(box.ups), (0, pad), value=-big)
    per_level = {}
    for lvl in range(levels - 1, max(built_level, 1) - 1, -1):
        lo = lo.view(3, -1, 2).amin(-1)
        up = up.view(3, -1, 2).amax(-1)
        m = tree.level_nodes(lvl)
        per_level[lvl] = (lo[:, :m], up[:, :m])
    chunks_lo, chunks_up = [], []
    for lvl in range(1, levels):
        if lvl in per_level:
            chunks_lo.append(per_level[lvl][0])
            chunks_up.append(per_level[lvl][1])
        else:
            z = torch.zeros(3, tree.level_nodes(lvl), dtype=dtype, device=dev)
            chunks_lo.append(z)
            chunks_up.append(z)
    flo = torch.cat(chunks_lo, dim=1)
    fup = torch.cat(chunks_up, dim=1)
    return BBox(tuple(flo), tuple(fup))


def _cat_volumes(parts) -> Volume:
    """Concatenate a list of same-kind volume batches."""
    if isinstance(parts[0], BSphere):
        return BSphere(tuple(torch.cat([p.xs[k] for p in parts])
                             for k in range(3)),
                       torch.cat([p.r for p in parts]))
    return BBox(tuple(torch.cat([p.los[k] for p in parts]) for k in range(3)),
                tuple(torch.cat([p.ups[k] for p in parts]) for k in range(3)))


def _aggregate(leaves_vol: Volume, tree: ImplicitTree, built_level: int,
               node_kind) -> Volume:
    """Nodes of ``node_kind`` in memory-index order (level 1 first).  BBox
    nodes take :func:`_aggregate_bbox`; BSphere nodes the generic
    level-by-level pairwise merge: leaf -> node conversion and
    ``merge_into`` at the level above the leaves, ``merge`` above it, and a
    parent whose right child is virtual is a copy of its left child.  Levels
    above ``built_level`` are zero-filled."""
    if node_kind is BBox:
        return _aggregate_bbox(leaves_vol, tree, built_level)
    if node_kind is not BSphere:
        raise TypeError(f"unknown node kind {node_kind}")
    dtype, dev = leaves_vol.dtype, leaves_vol.device
    levels = tree.levels

    def zero_level(m):
        z = torch.zeros(m, dtype=dtype, device=dev)
        return BSphere((z, z, z), z)

    if levels < 2 or tree.real_nodes < 2:
        return zero_level(max(tree.num_nodes, 0))

    def merge_level(child, n_child, m, first):
        pair = (lambda a, b: merge_into(node_kind, a, b)) if first else merge
        if n_child == 2 * m:
            return pair(child[0::2], child[1::2])
        merged = pair(child[0:n_child - 1:2], child[1:n_child:2])
        last = child[n_child - 1:n_child]
        if first:
            last = convert_volume(node_kind, last)
        return _cat_volumes([merged, last])

    per_level = {levels - 1: merge_level(
        leaves_vol, tree.real_leaves, tree.level_nodes(levels - 1), True)}
    for lvl in range(levels - 2, max(built_level, 1) - 1, -1):
        per_level[lvl] = merge_level(
            per_level[lvl + 1], tree.level_nodes(lvl + 1),
            tree.level_nodes(lvl), False)
    return _cat_volumes([per_level[lvl] if lvl in per_level
                         else zero_level(tree.level_nodes(lvl))
                         for lvl in range(1, levels)])


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
        leaves = bounding_volumes
        leaves = Leaves(leaves.volume,
                        as_tensor(leaves.index, options.index_dtype,
                                  leaves.volume.device), leaves.morton)
    else:
        leaves = wrap_bounding_volumes(bounding_volumes, options, indices)
    tree = ImplicitTree.from_num_leaves(leaves.index.shape[0])
    built_ilevel = compute_build_level(tree, built_level)
    dev = leaves.index.device

    alg = options.morton
    with tracing.span("build.morton", dev):
        if isinstance(alg, ExtendedMortonAlgorithm):
            morton = morton_encode_extended(leaves.volume, alg)
        elif isinstance(alg, DefaultMortonAlgorithm):
            morton = morton_encode(center_coords(leaves.volume), alg)
        else:
            raise TypeError(f"unsupported morton algorithm {alg}")
    with tracing.span("build.sort", dev):
        leaves = _sort_by_morton(Leaves(leaves.volume, leaves.index, morton))
    with tracing.span("build.nodes", dev):
        nodes = _aggregate(leaves.volume, tree, built_ilevel, node_kind)
        skips = compute_skips(tree, options.index_dtype, dev)
    return BVH(skips=skips, nodes=nodes, leaves=leaves,
               built_level=built_ilevel, tree=tree)
