"""The moving-geometry step as one function: the counterpart of the JAX
package's ``__graft_entry__.entry()``.

``entry()`` returns ``(step, (x, r))``: ``step`` rebuilds the BVH from
bounding spheres and runs fixed-capacity tile self-contact on the two-phase
route, and ``(x, r)`` are its example arguments, 8,192 spheres.  The step
makes no host sync, so a caller can capture it in a CUDA graph, as the JAX
package's caller jits it::

    step, (x, r) = entry()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up: builds and loads the kernels
        step(x, r)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        total, contacts = step(x, r)
    x.copy_(new_x); r.copy_(new_r)     # new spheres of the same count
    graph.replay()                     # total, contacts now hold theirs

A graph holds the shapes and capacities it was captured with: spheres of
another count need a new capture.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import build
from .traverse import TileTraversal, traverse_tiles_fixed
from .utils import as_tensor
from .volumes import BBox, BSphere

CAPACITY = 1 << 16
# the example scene is denser than unit density (radii up to 0.45 at unit
# spacing): diagonal tile pairs carry more than 32 contacts, hence the
# enlarged slot caps of the JAX package's 65k configurations
ALG = TileTraversal(row_cap=8, pair_cap=64)


def example_spheres(n: int, seed: int = 0, scale=None, device=None):
    """``n`` random spheres, centres ``(n, 3)`` and radii ``(n,)`` float32,
    at about unit density (``scale`` is the cube's side): the draws of the
    JAX package's ``__graft_entry__._example_spheres``, bit for bit."""
    rng = np.random.default_rng(seed)
    if scale is None:
        scale = float(n) ** (1.0 / 3.0)
    xs = (rng.random((n, 3)) * scale).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    return as_tensor(xs, device=device), as_tensor(rs, device=device)


def step(x: torch.Tensor, r: torch.Tensor):
    """One step: ``build(BSphere(x, r), BBox)`` then
    ``traverse_tiles_fixed`` at capacity 2^16 with ``row_cap=8,
    pair_cap=64``.  Returns ``(total, contacts)``: the contact count, with
    2^30 subtracted when a capacity or slot cap overflowed (the contacts
    are then incomplete), and the ``(2^16, 2)`` int32 contact list."""
    bvh = build(BSphere(x, r), BBox)
    total, contacts, overflow, _ = traverse_tiles_fixed(bvh, CAPACITY,
                                                        alg=ALG)
    return torch.where(overflow > 0, total - (1 << 30), total), contacts


def entry(device=None):
    """``(step, (x, r))``: the step and its example arguments,
    ``example_spheres(8192)`` on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    return step, example_spheres(8192, device=device)
