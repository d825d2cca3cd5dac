"""W1, the stackless leaf-vs-tree walk (``ops/walk.py:walk_lanes`` ->
``csrc/walk.cu``, device kernels ``walk_*``): its bytes and operations for
one pass, from the pass's arguments and the tests its diagnostic variant
counts."""

from __future__ import annotations

from . import peaks

KERNEL_PREFIX = "walk_"
# kinds as the walk numbers them: 0 sphere, 1 box, 2 ray
_SPHERE, _BOX, _RAY = 0, 1, 2
# float32 bytes of one volume's own fields: a sphere (x, r), a box (lo,
# up), a ray (p, d)
FIELD_BYTES = {_SPHERE: 16, _BOX: 24, _RAY: 24}


def kind(volume) -> int:
    return _BOX if type(volume).__name__ == "BBox" else _SPHERE


def test_flops(lane_kind: int, kind_: int) -> int:
    """Float operations of one test of a lane (0 sphere, 1 box, 2 ray)
    against a volume of ``kind_``; a box lane converts a sphere leaf on
    each test, a sphere lane is converted once."""
    if lane_kind == _RAY:
        return peaks.FLOPS_PER_TEST["ray_box" if kind_ == _BOX
                                    else "ray_sphere"]
    if lane_kind == kind_ == _SPHERE:
        return peaks.FLOPS_PER_TEST["sphere"]
    return peaks.FLOPS_PER_TEST["box"] + 6 * (lane_kind == _BOX
                                              and kind_ == _SPHERE)


def bound(target, lanes, node_tests: int, leaf_tests: int, written: int,
          write: bool, self_walk: bool) -> tuple:
    """``peaks.bound_ms`` of one pass of W1 over ``target`` (a BVH) for the
    leaf lanes ``lanes`` (a ``Leaves``), with the node and leaf tests its
    diagnostic variant counted.

    Bytes: each input once, the volumes by their own fields (a self walk's
    lanes are the target's leaves, counted once), the leaf index, skip
    table, per-lane counts, with the write pass its offsets and the
    ``written`` rows of two indices.  Operations: the node tests (lane
    against a node) and the leaf tests (lane against a leaf) times their
    float operations."""
    node_kind = kind(target.nodes)
    leaf_kind = kind(target.leaves.volume)
    lane_kind = kind(lanes.volume)
    n_nodes = target.nodes.batch_shape[0]
    n_leaves = target.leaves.volume.batch_shape[0]
    idx = target.skips.element_size()
    K = lanes.volume.batch_shape[0]
    nbytes = n_nodes * FIELD_BYTES[node_kind] + \
        n_leaves * FIELD_BYTES[leaf_kind] + \
        (target.leaves.index.numel() + target.skips.numel() + K) * idx
    if not self_walk:
        nbytes += K * FIELD_BYTES[lane_kind] + K * idx
    else:
        nbytes += K * idx                   # the dedup leaf indices
    if write:
        nbytes += K * idx + 2 * written * idx
    ops = node_tests * test_flops(lane_kind, node_kind) + \
        leaf_tests * test_flops(lane_kind, leaf_kind)
    return peaks.bound_ms(nbytes, ops, target.leaves.volume.dtype)
