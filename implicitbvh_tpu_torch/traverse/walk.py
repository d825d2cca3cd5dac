"""Stackless leaf-vs-tree walk: the core of the LVT traversals.

Counterpart of ``implicitbvh_tpu/traverse/walk.py:35-141``, in torch ops
(no kernel of its own).  Every lane (a leaf or a ray) carries only its
current implicit node index and all lanes advance in lockstep:

- on a hit at a node level, descend to the left child (``inode * 2``);
- otherwise climb over the trailing ones of the index (the right-child
  edges below the deepest unexplored right sibling) and step right; the
  climb is capped at ``start_level``, because the walk covers a forest of
  roots: a lane whose root is exhausted steps to the next root, or to 0
  when there is none.

Output takes two passes, count and write: the write pass scatters each
lane's contacts at ``offsets[lane] + running count``.

The JAX package runs the loop on the device (``lax.while_loop``).  Torch has
no such loop, so the test ``any(inode > 0)`` that ends it is a host sync.
Lanes that are done stay at 0 and a step leaves them alone, so the body
runs in blocks of ``BLOCK_STEPS`` steps with one test per block: the result
is that of testing every step, at most ``BLOCK_STEPS - 1`` idle steps
later.  ``stackless_walk.steps`` and ``stackless_walk.syncs`` count the
steps run and the tests made.

Per-lane shifts are int32: ``(cur + 1) << (levels - level)`` reaches
``2^levels``, so trees of up to 30 levels (2^29 leaves) fit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..tree import ImplicitTree, isvirtual_lanes, memory_index_lanes
from ..utils import floor_ilog2, trailing_ones
from ..volumes import Volume

BLOCK_STEPS = 32        # loop steps between two tests of the end condition
MAX_LEVELS = 30


def stackless_walk(
    tree: ImplicitTree,
    nodes: Volume,
    target_leaves,
    skips: torch.Tensor,
    start_level: int,
    node_test: Callable,           # (node volumes [K]) -> bool[K]
    leaf_test: Callable,           # (Leaves [K]) -> bool[K]
    emit: Callable,                # (Leaves [K]) -> int[K, 2]
    num_lanes: int,
    dedup_ileaf: Optional[torch.Tensor] = None,   # int[K] implicit leaf index
    capacity: int = 0,
    offsets: Optional[torch.Tensor] = None,       # int[K] write offsets
):
    """Run the walk for all lanes; returns ``(counts[K], out[capacity, 2])``.

    With ``capacity == 0`` this is the counting pass.  With a capacity and
    per-lane ``offsets``, lane k's contacts go to rows ``offsets[k] +
    (its running count)``; rows at or past ``capacity`` are dropped.

    ``dedup_ileaf``: subtrees whose rightmost leaf is at or left of the
    lane's own implicit leaf index are pruned (self-traversal reports each
    pair once).
    """
    levels = tree.levels
    if levels > MAX_LEVELS:
        raise ValueError(f"the walk's int32 shifts hold {MAX_LEVELS} levels, "
                         f"got {levels}")
    num_n = max(tree.num_nodes, 1)
    num_l = tree.real_leaves
    idt, dev = skips.dtype, skips.device

    first_root = 1 << (start_level - 1)
    last_root = first_root + tree.level_nodes(start_level) - 1
    leaf_base = (1 << (levels - 1)) - 1   # leaf j has implicit index j + base

    inode = torch.full((num_lanes,), first_root, dtype=idt, device=dev)
    counts = torch.zeros((num_lanes,), dtype=idt, device=dev)
    # one row past the capacity takes the writes that are dropped
    out = torch.zeros((capacity + 1, 2), dtype=idt, device=dev)
    if offsets is None:
        offsets = torch.zeros((num_lanes,), dtype=idt, device=dev)

    def body(inode, counts):
        active = inode > 0
        cur = inode.clamp(min=1)
        level = floor_ilog2(cur) + 1          # 1-based level of the node

        skip = isvirtual_lanes(tree, cur, level)   # a virtual right sibling
        if dedup_ileaf is not None:
            rightmost = ((cur + 1) << (levels - level)) - 1
            skip = skip | (rightmost <= dedup_ileaf)
        live = active & ~skip
        at_leaf = level == levels

        # gathers are clamped, so idle lanes read valid memory
        if tree.num_nodes > 0:
            mem0 = (memory_index_lanes(tree, cur, skips, level)
                    - 1).clamp(0, num_n - 1)
            descend = live & ~at_leaf & node_test(nodes[mem0.long()])
        else:       # a single-leaf tree stores no node
            descend = torch.zeros_like(active)

        leaf = target_leaves[(cur - leaf_base - 1).clamp(0, num_l - 1).long()]
        hit_leaf = live & at_leaf & leaf_test(leaf)
        if capacity > 0:
            pos = torch.where(hit_leaf, offsets + counts, capacity)
            out[pos.clamp(max=capacity).long()] = emit(leaf).to(idt)
        counts = counts + hit_leaf.to(idt)

        t = trailing_ones(cur)
        depth = level - start_level           # >= 0 while walking
        root = cur >> depth.clamp(min=0)
        subtree_done = t >= depth
        nxt = torch.where(subtree_done, root + 1, (cur >> t) + 1)
        nxt = torch.where(subtree_done & (root + 1 > last_root), 0, nxt)
        inode = torch.where(descend, 2 * cur, nxt)
        return torch.where(active, inode, 0), counts

    while True:
        for _ in range(BLOCK_STEPS):
            inode, counts = body(inode, counts)
        stackless_walk.steps += BLOCK_STEPS
        stackless_walk.syncs += 1
        if not bool((inode > 0).any()):       # the host sync
            break
    return counts, out[:capacity]


stackless_walk.steps = 0
stackless_walk.syncs = 0
