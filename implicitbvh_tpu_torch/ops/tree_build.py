"""The BVH build's Morton codes, sort and nodes: the CUDA kernels T1 and
their plain version.

:func:`tree_build_plain` is the build's chain of torch ops (the JAX
package's ``implicitbvh_tpu/build.py`` step for step): the Morton codes,
a stable sort of the int64 codes, a gather of every leaf field, the node
levels (BBox nodes by per-level pairwise min/max over a perfect tree padded
with ``finfo.max``; BSphere nodes by the level-by-level sphere merge) and
the skip table.  At 2^20 sphere leaves it is about 175 device operations.

:func:`tree_build` runs ``csrc/tree_build.cu`` (T1) on a CUDA device for
the inputs it takes (:func:`kernel_takes`): four launches around one
``torch.sort`` of int32 keys (int64 for the 64-bit order), the same
outputs bit for bit.  Every other input takes the plain version: CPU
tensors, BSphere nodes (the sphere merge is not associative), the extended
Morton order and half-precision leaves, whose arithmetic differs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..morton import (RELATIVE_PRECISION, DefaultMortonAlgorithm,
                      ExtendedMortonAlgorithm, morton_encode,
                      morton_encode_extended)
from ..tree import ImplicitTree, compute_skips
from ..volumes import (BBox, BSphere, bbox_of_bsphere, center_coords,
                       convert_volume, merge, merge_into)
from . import _build

# the slots a T1c block reduces: 2^K, K at most 10 (float32) or 9 (float64)
_TILE_LOG2 = {torch.float32: 10, torch.float64: 9}
_MAX_PARTIALS = 512      # T1a's blocks, at most


def _aggregate_bbox(leaves_vol, tree: ImplicitTree, built_level: int) -> BBox:
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


def _cat_volumes(parts):
    """Concatenate a list of same-kind volume batches."""
    if isinstance(parts[0], BSphere):
        return BSphere(tuple(torch.cat([p.xs[k] for p in parts])
                             for k in range(3)),
                       torch.cat([p.r for p in parts]))
    return BBox(tuple(torch.cat([p.los[k] for p in parts]) for k in range(3)),
                tuple(torch.cat([p.ups[k] for p in parts]) for k in range(3)))


def _aggregate(leaves_vol, tree: ImplicitTree, built_level: int, node_kind):
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


def tree_build_plain(volume, index, tree: ImplicitTree, built_level: int,
                     node_kind, options):
    """Plain PyTorch version of :func:`tree_build`."""
    dev = volume.device
    if index is None:
        index = torch.arange(1, tree.real_leaves + 1,
                             dtype=options.index_dtype, device=dev)
    alg = options.morton
    with tracing.span("build.morton", dev):
        if isinstance(alg, ExtendedMortonAlgorithm):
            morton = morton_encode_extended(volume, alg)
        elif isinstance(alg, DefaultMortonAlgorithm):
            morton = morton_encode(center_coords(volume), alg)
        else:
            raise TypeError(f"unsupported morton algorithm {alg}")
    with tracing.span("build.sort", dev):
        # the codes are unsigned bit patterns in int64 (a 64-bit extended
        # code may set bit 63): flipping the sign bit maps their unsigned
        # order to int64's
        perm = torch.sort(morton ^ (-1 << 63), stable=True).indices
        volume, index, morton = volume[perm], index[perm], morton[perm]
    with tracing.span("build.nodes", dev):
        nodes = _aggregate(volume, tree, built_level, node_kind)
        skips = compute_skips(tree, options.index_dtype, dev)
    return volume, index, morton, nodes, skips


def _fields(volume):
    if isinstance(volume, BSphere):
        return (*volume.xs, volume.r)
    return (*volume.los, *volume.ups)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def kernel_takes(volume, index, node_kind, options) -> bool:
    """True where T1 computes the build (the device aside): BSphere or BBox
    leaves whose fields are (n,) tensors of one dtype, float32 or float64,
    on one device, 1 <= n < 2^31; BBox nodes; the default Morton order (16,
    32 or 64 bits, computed or fixed extrema); any index width, user
    indices or none.  The other kinds keep the plain chain because their
    arithmetic differs: BSphere nodes, the extended order, float16 and
    bfloat16."""
    if node_kind is not BBox or type(volume) not in (BSphere, BBox) or \
            type(options.morton) is not DefaultMortonAlgorithm:
        return False
    fields = _fields(volume)
    n = fields[0].shape[0] if fields[0].dim() == 1 else 0
    if not 1 <= n < 1 << 31 or fields[0].dtype not in _TILE_LOG2:
        return False
    if any(f.dim() != 1 or f.shape[0] != n or f.dtype != fields[0].dtype
           or f.device != fields[0].device for f in fields):
        return False
    return index is None or index.device == fields[0].device


def tree_build(volume, index, tree: ImplicitTree, built_level: int,
               node_kind, options):
    """Sort the leaves along the Morton curve and build the nodes above
    them.

    - ``volume``: the (n,) :class:`BSphere` or :class:`BBox` leaves.
    - ``index``: their (n,) user indices in ``options.index_dtype``, or
      ``None`` for ``1 .. n``.
    - ``tree``: the :class:`ImplicitTree` of n leaves; ``built_level``: the
      level up to which nodes are built (1 .. ``tree.levels``).
    - ``node_kind``: :class:`BBox` or :class:`BSphere`; ``options``: the
      :class:`BVHOptions` (its Morton algorithm and index width).

    Returns ``(volume, index, morton, nodes, skips)``: the leaves, their
    indices and int64 codes in sorted order, the nodes in memory-index
    order (level 1 first, zeros above ``built_level``) and the per-level
    skip table in the index dtype.

    Replaces no TPU kernel: the JAX package builds in XLA ops.  On a CUDA
    device, for the inputs of :func:`kernel_takes`, ``csrc/tree_build.cu``
    (T1) computes it with no host sync: T1a, the extrema (only when
    computed); T1b, the int32 keys (int64 for the 64-bit order); then
    ``torch.sort(keys, stable=True)``, the path's one library call; T1c,
    the sorted leaves and 2^K levels of nodes a block; T1d, the levels
    above and the skip table.  Counts ``launches.tree_build`` once a
    build.  Everything else runs :func:`tree_build_plain`.
    """
    if index is not None and tuple(index.shape) != volume.batch_shape:
        raise ValueError(f"need an index per leaf: {tuple(index.shape)} "
                         f"indices for leaves of shape {volume.batch_shape}")
    if index is not None and index.dtype != options.index_dtype:
        raise TypeError(f"index must be {options.index_dtype}, got "
                        f"{index.dtype}")
    if volume.batch_shape != (tree.real_leaves,):
        raise ValueError(f"the tree has {tree.real_leaves} leaves, the "
                         f"volumes shape {volume.batch_shape}")
    if not 1 <= built_level <= tree.levels:
        raise ValueError(f"built_level {built_level} out of [1, "
                         f"{tree.levels}]")
    if _on_card(_fields(volume)[0]) and \
            kernel_takes(volume, index, node_kind, options):
        return _tree_build_cuda(volume, index, tree, built_level, options)
    return tree_build_plain(volume, index, tree, built_level, node_kind,
                            options)


def levels_of(tree: ImplicitTree):
    """``(counts, offsets)``, lists indexed by level 1 .. ``levels - 1``
    (entry 0 unused): each level's real nodes and its first node's offset
    in memory-index order, level 1 first."""
    counts = [0] + [tree.level_nodes(lvl) for lvl in range(1, tree.levels)]
    offsets = [0] * tree.levels
    for lvl in range(2, tree.levels):
        offsets[lvl] = offsets[lvl - 1] + counts[lvl - 1]
    return counts, offsets


def tile_log2(dtype, tree: ImplicitTree) -> int:
    """K: the levels a T1c block reduces, over 2^K sorted slots."""
    return min(tree.levels - 1, _TILE_LOG2[dtype])


def _tree_build_cuda(volume, index, tree, built_level, options):
    P, I, L = _build.P, _build.I, ctypes.c_longlong
    box = isinstance(volume, BBox)
    fields = _fields(volume)
    dt, dev = fields[0].dtype, fields[0].device
    n, levels, n_nodes = tree.real_leaves, tree.levels, max(tree.num_nodes, 0)
    alg = options.morton
    F = len(fields)
    ptrs = (ctypes.c_void_p * F)(*(f.data_ptr() for f in fields))
    strides = (L * F)(*(f.stride(0) for f in fields))
    f64 = int(dt == torch.float64)
    n_part = min(-(-n // 2048), 2 * torch.cuda.get_device_properties(
        dev).multi_processor_count, _MAX_PARTIALS)
    # the sorted leaves (F rows) and the nodes (6 rows), which the BVH keeps
    vals = torch.empty(F * n + 6 * n_nodes, dtype=dt, device=dev)
    # scratch, freed with the build: T1b's records of the leaves (4 values
    # a sphere, 8 a box, gathered by T1c through the permutation), T1a's
    # partials, then the keys
    es = fields[0].element_size()
    key_dtype = torch.int64 if alg.bits == 64 else torch.int32
    rec_bytes = n * (4 if F == 4 else 8) * es
    part_bytes = -(-6 * n_part * es // 8) * 8
    scratch = torch.empty(rec_bytes + part_bytes + n * (8 if alg.bits == 64
                                                        else 4),
                          dtype=torch.uint8, device=dev)
    keys = scratch[rec_bytes + part_bytes:].view(key_dtype)
    bounds = (ctypes.c_double * 6)(*alg.mins, *alg.maxs)
    codes = _build.kernel_fn("tree_build", "tree_codes_launch",
                             [P, P, I, I, L, I, I, I, P, ctypes.c_double,
                              P, P, P, P])
    with torch.cuda.device(dev):
        with tracing.span("build.morton", dev):
            _build.launch(codes, "tree_build", ptrs, strides, int(box), f64,
                          n, alg.bits, int(alg.compute_extrema), n_part,
                          bounds, RELATIVE_PRECISION[dt],
                          scratch.data_ptr() + rec_bytes, keys.data_ptr(),
                          scratch.data_ptr())
        with tracing.span("build.sort", dev):
            sorted_keys, perm = torch.sort(keys, stable=True)
        with tracing.span("build.nodes", dev):
            idx_dtype = options.index_dtype
            ints = torch.empty(n + levels, dtype=idx_dtype, device=dev)
            morton = torch.empty(n, dtype=torch.int64, device=dev)
            counts, offsets = levels_of(tree)
            zero_end = offsets[built_level] if built_level < levels \
                else n_nodes
            nodes_fn = _build.kernel_fn(
                "tree_build", "tree_nodes_launch",
                [P, I, I, L, I, P, P, P, L, I, P, P, P, P, L, P, P, I, I, I,
                 L, L, P, P])
            _build.launch(nodes_fn, "tree_build", scratch.data_ptr(),
                          int(box), f64, n, int(alg.bits == 64),
                          sorted_keys.data_ptr(), perm.data_ptr(),
                          None if index is None else index.data_ptr(),
                          0 if index is None else index.stride(0),
                          ints.element_size(), vals.data_ptr(),
                          ints.data_ptr(), morton.data_ptr(),
                          vals[F * n:].data_ptr(), n_nodes,
                          (L * levels)(*counts), (L * levels)(*offsets),
                          levels, tile_log2(dt, tree), built_level, zero_end,
                          tree.virtual_leaves, ints[n:].data_ptr())
    tracing.count("launches.tree_build")
    rows = vals[:F * n].view(F, n)
    node_rows = vals[F * n:F * n + 6 * n_nodes].view(6, n_nodes)
    leaves = BBox(tuple(rows[:3]), tuple(rows[3:])) if box else \
        BSphere(tuple(rows[:3]), rows[3])
    nodes = BBox(tuple(node_rows[:3]), tuple(node_rows[3:]))
    return leaves, ints[:n], morton, nodes, ints[n:]
