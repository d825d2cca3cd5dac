"""Breadth-first (BVTT frontier) traversal: one BVH, two BVHs, rays.

Counterpart of ``implicitbvh_tpu/traverse/bfs.py``, in torch ops (the JAX
package runs it as an XLA program; it has no Pallas kernel):

- static-capacity frontier buffers with a count of the valid lanes;
- per level: one gather of node volumes, one vectorised overlap test,
  masked 4-way (or 2-way) child sprouting, and deterministic stream
  compaction (``cumsum``, then a scatter whose dropped entries go to one
  row past the capacity): no atomics, and the JAX package's order;
- an overflow flag instead of a resize: the wrapper runs again with a grown
  capacity when the frontier outgrows its buffer.

The tree shape is a plain Python value, so the level loop (and the pair
traversal's six-phase machine for trees of unequal height) unrolls on the
host, and a ``*_fixed`` function syncs with the host nowhere; only the
wrapper's ``_run_with_growth`` reads the overflow flag, once per try.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from ..build import BVH
from ..options import DEFAULT_OPTIONS, BVHOptions
from ..utils import (k2ij_exclusive, leftleft, leftnoop, leftright,
                     noopleft, noopright, rightleft, rightnoop, rightright)
from ..volumes import iscontact, isintersection
from .types import BVHTraversal


# --------------------------------------------------------------------------
# Shared machinery
# --------------------------------------------------------------------------

def _compact(valid, vals1, vals2, capacity: int, idt):
    """Deterministic stream compaction of (vals1, vals2) where ``valid``.

    Returns ``(o1, o2, total)``: the survivors in order, zeros past them;
    survivors at or past ``capacity`` are dropped (the caller checks
    ``total > capacity`` for overflow).  ``total`` is an int64 tensor."""
    v = valid.to(torch.int64)
    pos = torch.cumsum(v, 0) - v               # exclusive scan
    posx = torch.where(valid, pos, capacity).clamp(max=capacity)
    dev = valid.device
    # one row past the capacity takes the dropped entries
    o1 = torch.zeros(capacity + 1, dtype=idt, device=dev)
    o2 = torch.zeros(capacity + 1, dtype=idt, device=dev)
    o1.scatter_(0, posx, vals1.to(idt))
    o2.scatter_(0, posx, vals2.to(idt))
    return o1[:capacity], o2[:capacity], v.sum()


def _expand(slots, capacity: int, idt):
    """Compact a list of sprout slots ``[(v1, v2, valid), ...]`` into the
    next frontier, slot-major within each source pair (the slots stacked on
    the last axis, then flattened)."""
    v1 = torch.stack([s[0] for s in slots], dim=-1).reshape(-1)
    v2 = torch.stack([s[1] for s in slots], dim=-1).reshape(-1)
    ok = torch.stack([s[2] for s in slots], dim=-1).reshape(-1)
    return _compact(ok, v1, v2, capacity, idt)


def _gather_nodes(bvh: BVH, implicit, level: int):
    """Node volumes of implicit indices on a static ``level``."""
    skips = bvh.tree.virtual_nodes_before_level(level)
    num_n = max(bvh.tree.num_nodes, 1)
    m = (implicit - skips - 1).clamp(0, num_n - 1)
    return bvh.nodes[m.long()]


def _gather_leaves(bvh: BVH, implicit):
    leaf_base = (1 << (bvh.tree.levels - 1)) - 1
    j = (implicit - leaf_base - 1).clamp(0, bvh.tree.real_leaves - 1)
    return bvh.leaves[j.long()]


def _virt_child(tree, i, level: int):
    """Is implicit child ``2i + 1`` (on static ``level + 1``) virtual?"""
    nreal_next = tree.level_nodes(level + 1)
    first_next = 1 << level
    return (2 * i + 1) - first_next + 1 > nreal_next


def _gather_nodes_traced(bvh: BVH, implicit, level):
    """Node volumes of implicit indices on per-lane levels (the DFS engine,
    whose per-lane stacks mix levels)."""
    num_n = max(bvh.tree.num_nodes, 1)
    lv = (level - 1).clamp(0, bvh.tree.levels - 1)
    m = (implicit - bvh.skips[lv.long()] - 1).clamp(0, num_n - 1)
    return bvh.nodes[m.long()]


def _virt_child_traced(tree, i, level, idt):
    """Is implicit child ``2i + 1`` (on per-lane ``level + 1``) virtual?"""
    levels = tree.levels
    first_next = torch.ones_like(i) << level
    shift = (levels - (level + 1)).clamp(0, levels)
    nreal_next = first_next - (torch.full_like(i, tree.virtual_leaves)
                               >> shift)
    return (2 * i + 1) - first_next + 1 > nreal_next


def _pad(a, capacity: int):
    """``a`` cut or zero-padded to ``capacity`` entries."""
    return torch.nn.functional.pad(
        a, (0, max(capacity - a.shape[0], 0)))[:capacity]


def _start(size: int, capacity: int, dev):
    """The frontier's valid count, ``num_checks`` and overflow flag for an
    initial frontier of ``size`` entries, as device scalars made without a
    host sync."""
    n = torch.full((), size, dtype=torch.int64, device=dev)
    return n, n.clone(), torch.full((), size > capacity, dtype=torch.bool,
                                    device=dev)


# --------------------------------------------------------------------------
# Single-BVH BFS
# --------------------------------------------------------------------------

def _initial_bvtt_single(bvh: BVH, start_level: int, idt):
    """All (i, j > i) pair checks at ``start_level`` (ref
    traverse_single.jl:64-167): n(n-1)/2 pairs, then the n self-check pairs
    (i, i) when above the leaf level."""
    n = bvh.tree.level_nodes(start_level)
    first = 1 << (start_level - 1)
    k = torch.arange(n * (n - 1) // 2, dtype=idt, device=bvh.device)
    pi, pj = k2ij_exclusive(n, k)
    i1 = pi + first
    i2 = pj + first
    if start_level != bvh.tree.levels:
        s = torch.arange(first, first + n, dtype=idt, device=bvh.device)
        i1 = torch.cat([i1, s])
        i2 = torch.cat([i2, s])
    return i1, i2


def bfs_single_fixed(bvh: BVH, start_level: int, capacity: int,
                     narrow=None):
    """Frontier expansion from ``start_level`` to the leaves, then the
    leaf-leaf contact pass, with no host sync.  Returns ``(total contacts,
    contacts (capacity, 2), num_checks, overflow)`` as tensors."""
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels
    dev = bvh.device

    i1, i2 = _initial_bvtt_single(bvh, start_level, idt)
    n, num_checks, overflow = _start(i1.shape[0], capacity, dev)
    i1, i2 = _pad(i1, capacity), _pad(i2, capacity)

    lane = torch.arange(capacity, dtype=idt, device=dev)
    for level in range(start_level, levels):
        mask = lane < n
        is_self = (i1 == i2) & mask
        self_checks = level < levels - 1

        v1 = _gather_nodes(bvh, i1, level)
        v2 = _gather_nodes(bvh, i2, level)
        hit = iscontact(v1, v2) & mask & ~is_self

        # in single-tree traversal i1 < i2 for pair checks, so i1's children
        # are always real; only i2's right child may be virtual
        # (ref traverse_single_cpu.jl:110-121)
        virt2 = _virt_child(tree, i2, level)
        slots = [
            # self (i,i) -> (2i,2i), (2i,2i+1), (2i+1,2i+1); pair -> 4-way
            (*leftleft(i1, i2), (is_self & self_checks) | hit),
            (*leftright(i1, i2), (is_self | hit) & ~virt2),
            (*rightleft(i1, i2), hit),
            (*rightright(i1, i2),
             (is_self & self_checks & ~virt2) | (hit & ~virt2)),
        ]
        i1, i2, n = _expand(slots, capacity, idt)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)

    # leaf-leaf pass (ref traverse_leaves_range!, traverse_single_cpu.jl)
    mask = lane < n
    leaf1 = _gather_leaves(bvh, i1)
    leaf2 = _gather_leaves(bvh, i2)
    hit = iscontact(leaf1.volume, leaf2.volume) & mask
    if narrow is not None:
        hit = hit & narrow(leaf1, leaf2)
    a = torch.minimum(leaf1.index, leaf2.index)
    b = torch.maximum(leaf1.index, leaf2.index)
    o1, o2, total = _compact(hit, a, b, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, torch.stack([o1, o2], dim=-1), num_checks, overflow


def _run_with_growth(fn, capacity0: int, options: BVHOptions, max_tries=10):
    """``fn(capacity)`` from ``capacity0``, grown by the options' factor
    until it does not overflow; one host sync per try.  Returns ``(total,
    contacts, num_checks)`` with Python ints.  The counter ``bfs.runs`` of
    ``tracing`` counts the tries."""
    cap = capacity0
    for _ in range(max_tries):
        tracing.count("bfs.runs")
        total, out, num_checks, overflow = fn(cap)
        if not tracing.to_bool(overflow, "bfs.overflow"):
            return (tracing.to_int(total, "bfs.total"), out,
                    tracing.to_int(num_checks, "bfs.checks"))
        cap = int(cap * options.capacity_growth)
    raise RuntimeError(f"BFS frontier kept overflowing (capacity {cap})")


def _bfs_capacity0(n_init: int, num_leaves: int, options: BVHOptions) -> int:
    need = max(options.min_capacity, 4 * n_init, 8 * num_leaves)
    return 1 << math.ceil(math.log2(need))


def _cached_capacity(cache):
    """A previous BFS result's capacity, taken as it is, or None."""
    if cache is not None and getattr(cache, "cache1", None) is not None \
            and cache.cache1.dim() == 2 and cache.cache1.shape[0] > 0:
        return cache.cache1.shape[0]
    return None


def _result(bvh: BVH, total, out, num_checks, start_level1,
            start_level2=0):
    return BVHTraversal(
        num_contacts=total, cache1=out,
        cache2=torch.zeros((0,), dtype=bvh.skips.dtype, device=bvh.device),
        start_level1=start_level1, start_level2=start_level2,
        num_checks=num_checks)


def traverse_bfs_single(bvh: BVH, *, start_level: int, narrow=None,
                        cache=None, options: BVHOptions = DEFAULT_OPTIONS):
    """BFS self-contact with capacity growth; contacts are sorted ``(min,
    max)`` user-index pairs in frontier order."""
    n = bvh.tree.level_nodes(start_level)
    cap0 = _cached_capacity(cache) or _bfs_capacity0(
        n * (n + 1) // 2, bvh.num_leaves, options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_single_fixed(bvh, start_level, c, narrow), cap0,
        options)
    return _result(bvh, total, out, num_checks, start_level)


# --------------------------------------------------------------------------
# Pair BFS: the six-phase machine for trees of unequal height
# (ref traverse_pair.jl)
# --------------------------------------------------------------------------

def _initial_bvtt_pair(bvh1: BVH, bvh2: BVH, sl1: int, sl2: int, idt):
    """The full n1 x n2 cross product of the start levels' real nodes (ref
    traverse_pair.jl:154-219)."""
    n1 = bvh1.tree.level_nodes(sl1)
    n2 = bvh2.tree.level_nodes(sl2)
    k = torch.arange(n1 * n2, dtype=idt, device=bvh1.device)
    return k // n2 + (1 << (sl1 - 1)), k % n2 + (1 << (sl2 - 1))


def bfs_pair_fixed(bvh1: BVH, bvh2: BVH, sl1: int, sl2: int, capacity: int,
                   narrow=None):
    """Two-tree BFS from start levels ``sl1``/``sl2`` with no host sync.
    Returns ``(total, contacts (capacity, 2) in tree order (index in bvh1,
    index in bvh2), num_checks, overflow)``."""
    t1, t2 = bvh1.tree, bvh2.tree
    L1, L2 = t1.levels, t2.levels
    idt = bvh1.skips.dtype
    dev = bvh1.device

    i1, i2 = _initial_bvtt_pair(bvh1, bvh2, sl1, sl2, idt)
    n, num_checks, overflow = _start(i1.shape[0], capacity, dev)
    i1, i2 = _pad(i1, capacity), _pad(i2, capacity)
    lane = torch.arange(capacity, dtype=idt, device=dev)

    def sprout(slots, num_checks, overflow):
        i1, i2, n = _expand(slots, capacity, idt)
        return i1, i2, n, num_checks + n, overflow | (n > capacity)

    def four_way(i1, i2, hit, virt1, virt2):
        return [(*leftleft(i1, i2), hit),
                (*leftright(i1, i2), hit & ~virt2),
                (*rightleft(i1, i2), hit & ~virt1),
                (*rightright(i1, i2), hit & ~virt1 & ~virt2)]

    level1, level2 = sl1, sl2
    # phase A: both BVHs above their last node level: 4-way sprout
    while level1 < L1 - 1 and level2 < L2 - 1:
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & (lane < n)
        slots = four_way(i1, i2, hit, _virt_child(t1, i1, level1),
                         _virt_child(t2, i2, level2))
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)
        level1 += 1
        level2 += 1

    # phase B: only BVH1 still above its last node level: 2-way left sprout
    while level1 < L1 - 1 and level2 == L2 - 1:
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & (lane < n)
        virt1 = _virt_child(t1, i1, level1)
        slots = [(*leftnoop(i1, i2), hit),
                 (*rightnoop(i1, i2), hit & ~virt1)]
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)
        level1 += 1

    # phase C: only BVH2 still above its last node level: 2-way right sprout
    while level2 < L2 - 1 and level1 == L1 - 1:
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & (lane < n)
        virt2 = _virt_child(t2, i2, level2)
        slots = [(*noopleft(i1, i2), hit),
                 (*noopright(i1, i2), hit & ~virt2)]
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)
        level2 += 1

    # phase D: BVH2 already at its leaf level: node1-vs-leaf2 checks
    while level2 == L2 and level1 < L1:
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_leaves(bvh2, i2).volume) & (lane < n)
        virt1 = _virt_child(t1, i1, level1)
        slots = [(*leftnoop(i1, i2), hit),
                 (*rightnoop(i1, i2), hit & ~virt1)]
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)
        level1 += 1

    # phase E: BVH1 already at its leaf level: leaf1-vs-node2 checks
    while level1 == L1 and level2 < L2:
        hit = iscontact(_gather_leaves(bvh1, i1).volume,
                        _gather_nodes(bvh2, i2, level2)) & (lane < n)
        virt2 = _virt_child(t2, i2, level2)
        slots = [(*noopleft(i1, i2), hit),
                 (*noopright(i1, i2), hit & ~virt2)]
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)
        level2 += 1

    # phase F: both at the level above their leaves: the last 4-way sprout
    if level1 == L1 - 1 and level2 == L2 - 1:
        hit = iscontact(_gather_nodes(bvh1, i1, level1),
                        _gather_nodes(bvh2, i2, level2)) & (lane < n)
        slots = four_way(i1, i2, hit, _virt_child(t1, i1, level1),
                         _virt_child(t2, i2, level2))
        i1, i2, n, num_checks, overflow = sprout(slots, num_checks, overflow)

    # leaf-leaf pass, in tree order (ref traverse_leaves_pair_range!,
    # traverse_pair_cpu.jl:615-645)
    leaf1 = _gather_leaves(bvh1, i1)
    leaf2 = _gather_leaves(bvh2, i2)
    hit = iscontact(leaf1.volume, leaf2.volume) & (lane < n)
    if narrow is not None:
        hit = hit & narrow(leaf1, leaf2)
    o1, o2, total = _compact(hit, leaf1.index, leaf2.index, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, torch.stack([o1, o2], dim=-1), num_checks, overflow


def traverse_bfs_pair(bvh1: BVH, bvh2: BVH, *, start_level1: int,
                      start_level2: int, narrow=None, cache=None,
                      options: BVHOptions = DEFAULT_OPTIONS):
    """Two-tree BFS with capacity growth; contacts in tree order."""
    n_init = (bvh1.tree.level_nodes(start_level1) *
              bvh2.tree.level_nodes(start_level2))
    cap0 = _cached_capacity(cache) or _bfs_capacity0(
        n_init, max(bvh1.num_leaves, bvh2.num_leaves), options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_pair_fixed(bvh1, bvh2, start_level1, start_level2, c,
                                 narrow), cap0, options)
    return _result(bvh1, total, out, num_checks, start_level1, start_level2)


# --------------------------------------------------------------------------
# Ray BFS (ref raytrace/breadth_first/breadth_first.jl)
# --------------------------------------------------------------------------

def bfs_rays_fixed(bvh: BVH, points, directions, start_level: int,
                   capacity: int, narrow=None):
    """Node-ray BVTT with at most 2 sprouts per hit, with no host sync;
    ``points``/``directions`` are coordinate tuples of (K,) tensors.
    Returns ``(total, hits (capacity, 2) as (leaf user index, 1-based ray
    index), num_checks, overflow)``."""
    tree = bvh.tree
    idt = bvh.skips.dtype
    levels = tree.levels
    dev = bvh.device
    nrays = points[0].shape[0]

    # the initial cross product: (node at start_level) x ray
    n_nodes = tree.level_nodes(start_level)
    k = torch.arange(n_nodes * nrays, dtype=idt, device=dev)
    inode = k // nrays + (1 << (start_level - 1))
    iray = k % nrays                       # 0-based lane into the rays
    n, num_checks, overflow = _start(inode.shape[0], capacity, dev)
    inode, iray = _pad(inode, capacity), _pad(iray, capacity)
    lane = torch.arange(capacity, dtype=idt, device=dev)

    def ray_of(ir):
        j = ir.clamp(0, nrays - 1).long()
        return tuple(c[j] for c in points), tuple(c[j] for c in directions)

    for level in range(start_level, levels):
        hit = isintersection(_gather_nodes(bvh, inode, level),
                             *ray_of(iray)) & (lane < n)
        virt = _virt_child(tree, inode, level)
        slots = [(2 * inode, iray, hit),
                 (2 * inode + 1, iray, hit & ~virt)]
        inode, iray, n = _expand(slots, capacity, idt)
        num_checks = num_checks + n
        overflow = overflow | (n > capacity)

    leaf = _gather_leaves(bvh, inode)
    p, d = ray_of(iray)
    hit = isintersection(leaf.volume, p, d) & (lane < n)
    if narrow is not None:
        hit = hit & narrow(leaf, p, d)
    o1, o2, total = _compact(hit, leaf.index, iray + 1, capacity, idt)
    overflow = overflow | (total > capacity)
    return total, torch.stack([o1, o2], dim=-1), num_checks, overflow


def traverse_rays_bfs(bvh: BVH, points, directions, *, start_level: int,
                      narrow=None, options: BVHOptions = DEFAULT_OPTIONS):
    """Ray BFS with capacity growth; ``points``/``directions`` are
    coordinate tuples of (K,) tensors on the BVH's device."""
    nrays = points[0].shape[0]
    cap0 = _bfs_capacity0(bvh.tree.level_nodes(start_level) * nrays,
                          max(bvh.num_leaves, nrays), options)
    total, out, num_checks = _run_with_growth(
        lambda c: bfs_rays_fixed(bvh, points, directions, start_level, c,
                                 narrow), cap0, options)
    return _result(bvh, total, out, num_checks, start_level)
