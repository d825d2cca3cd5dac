"""Depth-first (DFS) self-contact traversal.

Counterpart of ``implicitbvh_tpu/traverse/dfs.py:53-164``.  Every lane is
one initial BVTT pair at ``start_level`` and carries its own stack of
pending (i1, i2) implicit pairs: pop, ``iscontact``, a 4-way push.  Output
takes the LVT walk's two passes: a count pass, an exclusive scan of the
per-lane counts, and a write pass at those offsets.  Contact sets equal
the LVT walk's and BFS's.

The JAX package runs the loop on the device (``lax.while_loop``).
:func:`dfs_single_fixed` is the pass's one router.  On the card with no
``narrow`` it runs kernel W2 (``ops.dfs_lanes``, ``csrc/dfs.cu``; float32
or float64 volumes): each lane's stack runs as work items in rounds of a
few steps, its rows placed in the lane's order; no host sync, and a CUDA
graph captures the count, the scan and the write.  For CPU tensors, and
with a ``narrow`` callback (Python, which no kernel can call) on every
device, the pass is W2's plain version :func:`dfs_lanes_plain`, the
torch-op loop: all lanes in lockstep with their stacks in one (lanes,
DEPTH, 2) tensor, a masked 4-way push (the four children in one scatter,
each at the stack pointer plus the number of children pushed before it).
Torch has no device-side loop, so its end test ``any(sp > 0)`` is a host
sync.  A step leaves a lane whose stack is empty alone (``active`` gates
every push, count and write), so the body runs in blocks of
``BLOCK_STEPS`` steps with one test per block, as ``walk.py`` does; the
counters ``dfs.steps`` and ``syncs.dfs.end`` of ``tracing`` count the
steps run and the tests made.

The sprouting rules are single-tree BFS's: i1 < i2 for pair checks, so
only i2's right child can be virtual; a self pair (i, i) sprouts (ll, lr,
rr), with ll and rr left out at the level above the leaves.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..build import BVH
from ..ops._build import cuda_device
from ..ops.walk import dfs_lanes, stack_depth
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..utils import floor_ilog2
from ..volumes import iscontact
from .bfs import (_gather_leaves, _gather_nodes_traced, _initial_bvtt_single,
                  _virt_child_traced)
from .lvt import _round_capacity, _scan
from .types import BVHTraversal
from .walk import BLOCK_STEPS


def dfs_single_fixed(bvh: BVH, start_level: int, capacity: int = 0,
                     offsets=None, narrow=None):
    """One DFS pass over all lanes; returns ``(counts, out)``.

    ``capacity == 0``: the counting pass (``out`` is one zero row).  With
    ``capacity`` and per-lane ``offsets``: the write pass, which scatters
    sorted ``(min, max)`` user-index pairs at ``offsets[lane] + (the lane's
    running count)``; rows at or past ``capacity`` are dropped.  On the
    card with no ``narrow``: kernel W2 (``ops.dfs_lanes``, no host sync).
    For CPU tensors, and with ``narrow`` on every device:
    :func:`dfs_lanes_plain`, whose end test syncs with the host once per
    ``BLOCK_STEPS`` steps.
    """
    if narrow is None and cuda_device(bvh.skips):
        return dfs_lanes(bvh, start_level, capacity=capacity,
                         offsets=offsets)
    return dfs_lanes_plain(bvh, start_level, capacity=capacity,
                           offsets=offsets, narrow=narrow)


def dfs_lanes_plain(bvh: BVH, start_level: int, capacity: int = 0,
                    offsets=None, narrow=None):
    """The torch-op loop of :func:`dfs_single_fixed`, on any device (W2's
    plain version, and the ``narrow`` route)."""
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels
    dev = bvh.device

    i1_0, i2_0 = _initial_bvtt_single(bvh, start_level, idt)
    lanes = i1_0.shape[0]
    DEPTH = stack_depth(levels, start_level)

    # the stacks hold the pending pairs, slot 0 seeded with the lane's own
    # pair; one slot past DEPTH takes the pushes that are dropped
    st = torch.zeros((lanes, DEPTH + 1, 2), dtype=idt, device=dev)
    st[:, 0, 0] = i1_0
    st[:, 0, 1] = i2_0
    sp = torch.ones((lanes,), dtype=idt, device=dev)
    counts = torch.zeros((lanes,), dtype=idt, device=dev)
    # one row past the capacity takes the writes that are dropped
    out = torch.zeros((max(capacity, 1) + 1, 2), dtype=idt, device=dev)
    if offsets is None:
        offsets = torch.zeros((lanes,), dtype=idt, device=dev)
    lane_ids = torch.arange(lanes, device=dev)
    # child offsets of the four pushes, in push order: ll, lr, rl, rr (made
    # on the device: (k >> 1, k & 1) for k = 0..3)
    k4 = torch.arange(4, dtype=idt, device=dev)
    sprout = torch.stack([k4 >> 1, k4 & 1], 1)

    def body(st, sp, counts):
        active = sp > 0
        i1, i2 = st[lane_ids, (sp - 1).clamp(min=0).long()].unbind(1)
        sp = torch.where(active, sp - 1, sp)

        pair = torch.stack([i1, i2]).clamp(min=1)     # (2, lanes)
        i1c, i2c = pair[0], pair[1]
        level = floor_ilog2(i1c) + 1       # pair nodes share one level
        at_leaf = level == levels
        is_self = (i1 == i2) & active
        self_checks = level < levels - 1

        # leaf-leaf contact (ref traverse_single_cpu.jl:184-219); both
        # members of the pair in one gather
        leaves = _gather_leaves(bvh, pair)
        leaf1, leaf2 = leaves[0], leaves[1]
        hit_leaf = active & at_leaf & ~is_self & \
            iscontact(leaf1.volume, leaf2.volume)
        if narrow is not None:
            hit_leaf = hit_leaf & narrow(leaf1, leaf2)
        if capacity > 0:
            a = torch.minimum(leaf1.index, leaf2.index)
            b = torch.maximum(leaf1.index, leaf2.index)
            pos = torch.where(hit_leaf, offsets + counts, capacity)
            out[pos.clamp(max=capacity).long()] = \
                torch.stack([a, b], dim=-1).to(idt)
        counts = counts + hit_leaf.to(idt)

        # node-pair test and the 4-way depth-first sprout
        nodes = _gather_nodes_traced(bvh, pair, level)
        hit = active & ~at_leaf & ~is_self & iscontact(nodes[0], nodes[1])
        virt2 = _virt_child_traced(tree, i2c, level, idt)
        kids = 2 * pair.t()[:, None, :] + sprout
        self_down = is_self & self_checks & ~at_leaf
        ok = torch.stack([self_down | hit,               # (lanes, 4)
                          ((is_self & ~at_leaf) | hit) & ~virt2,
                          hit,
                          (self_down | hit) & ~virt2], 1)
        oki = ok.to(idt)
        npush = torch.cumsum(oki, 1, dtype=idt)          # inclusive
        dst = torch.where(ok, sp[:, None] + npush - oki, DEPTH)
        st[lane_ids[:, None], dst.clamp(max=DEPTH).long()] = kids
        return st, sp + npush[:, 3], counts

    while lanes:
        for _ in range(BLOCK_STEPS):
            st, sp, counts = body(st, sp, counts)
        tracing.count("dfs.steps", BLOCK_STEPS)
        if not tracing.to_bool((sp > 0).any(), "dfs.end"):
            break
    return counts, out[:max(capacity, 1)]


def traverse_dfs_single(bvh: BVH, *, start_level: int, narrow=None,
                        cache=None,
                        options: BVHOptions = DEFAULT_OPTIONS
                        ) -> BVHTraversal:
    """Count pass -> exclusive scan -> write pass (the LVT two-pass scheme,
    ref traverse_single.jl:52-78); contacts are sorted ``(min, max)``
    user-index pairs, lane by lane.  ``cache2`` holds the offsets."""
    counts, _ = dfs_single_fixed(bvh, start_level, narrow=narrow)
    offsets, total = _scan(counts)
    total = tracing.to_int(total, "dfs.total")
    capacity = _round_capacity(total, options, cache)
    _, out = dfs_single_fixed(bvh, start_level, capacity=capacity,
                              offsets=offsets, narrow=narrow)
    return BVHTraversal(num_contacts=total, cache1=out, cache2=offsets,
                        start_level1=start_level)
