"""The plain reference: bounding spheres of triangles, their contact set
and the hits of rays on them, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
works the spheres out again from the triangles that the benchmark made
(particles are spheres as the benchmark made them), and the contact or
hit set from those spheres, by methods that share no
code with the program (a uniform grid for contacts, a brute force for
rays).

The spheres and the two tests follow ImplicitBVH.jl's definitions (the
Ericson circumsphere of ``src/bounding_volumes/bsphere.jl`` with its
collinear and obtuse cases; touching spheres ``|c_a - c_b|^2 <= (r_a +
r_b)^2``; the forward-ray discriminant test) operation for operation, one
IEEE operation per tensor op, so that a pair on the boundary comes out as
the library defines it.  ``dtype`` sets the precision of every operation:
float32 as the configurations state, or a lower one for the control.
"""

from __future__ import annotations

import itertools

import torch


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sqrt(x):
    """Correctly rounded square root: the float64 root of a float32 (or
    narrower) value, rounded back once, is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def _dist(a, b):
    d = [a[k] - b[k] for k in range(3)]
    return _sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def spheres(tris: torch.Tensor, dtype=torch.float32):
    """``(centres (3, n), radii (n,))`` of the triangles ``tris`` (``(3
    vertices, 3 coordinates, n)``), computed in ``dtype``."""
    a, b, c = (list(tris[v].to(dtype)) for v in range(3))
    ab = [b[k] - a[k] for k in range(3)]
    ac = [c[k] - a[k] for k in range(3)]
    abab, abac, acac = _dot(ab, ab), _dot(ab, ac), _dot(ac, ac)
    d = 2.0 * (abab * acac - abac * abac)
    flat = d.abs() <= torch.finfo(dtype).eps
    lo = [torch.minimum(torch.minimum(a[k], b[k]), c[k]) for k in range(3)]
    up = [torch.maximum(torch.maximum(a[k], b[k]), c[k]) for k in range(3)]
    c_flat = [0.5 * (lo[k] + up[k]) for k in range(3)]
    d1 = torch.where(flat, torch.ones_like(d), d)
    s = (abab * acac - acac * abac) / d1
    t = (acac * abab - abab * abac) / d1
    c_in = [a[k] + s * ab[k] + t * ac[k] for k in range(3)]
    c_ac = [0.5 * (a[k] + c[k]) for k in range(3)]
    c_ab = [0.5 * (a[k] + b[k]) for k in range(3)]
    c_bc = [0.5 * (b[k] + c[k]) for k in range(3)]
    centre, radius = c_in, _dist(c_in, a)
    # the library's branches in order: a later case wins
    for cond, cc, rc in ((s + t >= 1.0, c_bc, _dist(c_bc, b)),
                         (t <= 0.0, c_ab, _dist(c_ab, a)),
                         (s <= 0.0, c_ac, _dist(c_ac, a)),
                         (flat, c_flat, _dist(c_flat, up))):
        centre = [torch.where(cond, cc[k], centre[k]) for k in range(3)]
        radius = torch.where(cond, rc, radius)
    return torch.stack(centre), radius


def leaves(inputs: dict, dtype=torch.float32):
    """``(centres (3, n), radii (n,))`` of one step's leaves in ``dtype``:
    the spheres of its triangles ``tris``, or its particles ``x``, ``r``."""
    if "tris" in inputs:
        return spheres(inputs["tris"], dtype)
    return inputs["x"].to(dtype), inputs["r"].to(dtype)


def n_leaves(inputs: dict) -> int:
    """The number of leaves (triangles or particles) of one step's
    inputs."""
    return inputs["tris"].shape[2] if "tris" in inputs else \
        inputs["r"].shape[0]


def self_contact_keys(x: torch.Tensor, r: torch.Tensor,
                      block: int = 1 << 18) -> torch.Tensor:
    """Sorted int64 keys ``i * n + j`` (0-based, ``i < j``) of every pair of
    spheres that touch, ``|x_i - x_j|^2 <= (r_i + r_j)^2`` in the spheres'
    dtype.  Candidates come from a uniform grid whose cells are wider than
    the largest contact distance, so a touching pair lies in one cell or
    two neighbouring ones; rows go in blocks of ``block`` spheres."""
    n = r.shape[0]
    dev = r.device
    if n < 2:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    xd = x.double()
    cell = 2.0 * float(r.double().max()) * (1.0 + 1e-3) + 1e-9
    q = torch.floor((xd - xd.min(1, keepdim=True).values) / cell).long() + 1
    dims = q.max(1).values + 2
    key = (q[0] * dims[1] + q[1]) * dims[2] + q[2]
    skey, order = torch.sort(key)
    offsets = torch.tensor(
        [(dx * int(dims[1]) + dy) * int(dims[2]) + dz
         for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3)],
        device=dev)
    found = []
    for s0 in range(0, n, block):
        i = torch.arange(s0, min(s0 + block, n), device=dev)
        nk = key[i][:, None] + offsets[None, :]                # (B, 27)
        first = torch.searchsorted(skey, nk)
        cnt = torch.searchsorted(skey, nk, right=True) - first
        ii = i[:, None].expand_as(cnt).reshape(-1)
        rep = cnt.reshape(-1)
        ii = torch.repeat_interleave(ii, rep)
        start = torch.repeat_interleave(first.reshape(-1), rep)
        run_start = torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep)
        jj = order[start + torch.arange(ii.shape[0], device=dev) - run_start]
        keep = ii < jj
        ii, jj = ii[keep], jj[keep]
        rr = r[ii] + r[jj]
        d = [x[k][ii] - x[k][jj] for k in range(3)]
        hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
        found.append(ii[hit] * n + jj[hit])
    return torch.sort(torch.cat(found)).values


def ray_hit_keys(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                 d: torch.Tensor, tests: int = 1 << 26) -> torch.Tensor:
    """Sorted int64 keys ``leaf * n_rays + ray`` (0-based) of every forward
    ray that meets a sphere (discriminant test), rays ``p``/``d`` of shape
    ``(3, n_rays)`` cast to the spheres' dtype; a brute force over chunks of
    about ``tests`` ray-sphere tests."""
    p, d = p.to(r.dtype), d.to(r.dtype)
    n_rays = p.shape[1]
    qa = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rsq = r * r
    chunk = max(1, tests // max(1, r.shape[0]))
    found = []
    for s0 in range(0, n_rays, chunk):
        sl = slice(s0, min(s0 + chunk, n_rays))
        po = [p[k, sl, None] - x[k][None, :] for k in range(3)]
        dk = [d[k, sl, None] for k in range(3)]
        qb = 2.0 * (po[0] * dk[0] + po[1] * dk[1] + po[2] * dk[2])
        qc = po[0] * po[0] + po[1] * po[1] + po[2] * po[2] - rsq[None, :]
        disc = qb * qb - 4.0 * qa[sl, None] * qc
        hit = (disc >= 0) & ((qb <= 0) | (qc <= 0))
        ray, leaf = hit.nonzero(as_tuple=True)
        found.append(leaf * n_rays + ray + s0)
        del po, qb, qc, disc, hit
    return torch.sort(torch.cat(found)).values
