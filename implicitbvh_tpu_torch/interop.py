"""State carried across from the JAX package: a BVH given as numpy arrays.

``bvh_from_numpy`` rebuilds the port's :class:`~.build.BVH` from a flat
dict of numpy arrays, so the same Morton-sorted BVH can feed both
traversals and a build difference is told apart from a traversal one.
The dict holds:

- ``"leaf_kind"``: ``"sphere"`` or ``"box"``;
- the sorted leaf volume fields: ``leaf_x0, leaf_x1, leaf_x2, leaf_r``
  (spheres) or ``leaf_lo0..2, leaf_up0..2`` (boxes);
- ``"index"`` (user indices, int32 or int64, kept so) and ``"morton"``
  (codes of any integer type; uint64 codes keep their bit pattern in
  int64);
- the node fields: ``node_lo0..2, node_up0..2`` (BBox nodes) or
  ``node_x0..2, node_r`` (BSphere nodes);
- ``"skips"``, ``"built_level"`` and ``"num_leaves"``.

``rays_from_numpy`` turns numpy ``(3, N)`` ray origins and directions into
the port's tensors, so that a test feeds both packages the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import BVH, Leaves
from .tree import ImplicitTree
from .utils import resolve_device
from .volumes import BBox, BSphere


def bvh_from_numpy(d: dict, device=None) -> BVH:
    dev = resolve_device(device)

    def t(key, dtype=None):
        return torch.tensor(np.asarray(d[key]), dtype=dtype, device=dev)

    if d["leaf_kind"] == "sphere":
        vol = BSphere(tuple(t(f"leaf_x{k}") for k in range(3)), t("leaf_r"))
    elif d["leaf_kind"] == "box":
        vol = BBox(tuple(t(f"leaf_lo{k}") for k in range(3)),
                   tuple(t(f"leaf_up{k}") for k in range(3)))
    else:
        raise ValueError(f"unknown leaf_kind {d['leaf_kind']!r}")
    morton = np.asarray(d["morton"])
    morton = morton.view(np.int64) if morton.dtype == np.uint64 \
        else morton.astype(np.int64)
    idt = torch.int64 if np.asarray(d["index"]).dtype.itemsize == 8 \
        else torch.int32
    leaves = Leaves(vol, t("index", idt), torch.tensor(morton, device=dev))
    if "node_r" in d:
        nodes = BSphere(tuple(t(f"node_x{k}") for k in range(3)), t("node_r"))
    else:
        nodes = BBox(tuple(t(f"node_lo{k}") for k in range(3)),
                     tuple(t(f"node_up{k}") for k in range(3)))
    return BVH(skips=t("skips", idt), nodes=nodes, leaves=leaves,
               built_level=int(d["built_level"]),
               tree=ImplicitTree.from_num_leaves(int(d["num_leaves"])))


def rays_from_numpy(points, directions, device=None):
    """``(points, directions)`` as float32 ``(3, N)`` tensors on ``device``
    (resolved as in ``utils.resolve_device``: CUDA unless told otherwise)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    directions = np.asarray(directions, np.float32)
    if points.ndim != 2 or points.shape[0] != 3 or \
            directions.shape != points.shape:
        raise ValueError(f"rays must be two (3, N) arrays, got "
                         f"{points.shape} and {directions.shape}")
    return (torch.tensor(points, device=dev),
            torch.tensor(directions, device=dev))
