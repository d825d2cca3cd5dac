"""Bounding volumes: coordinate-tuple SoA bounding spheres and boxes.

Counterpart of ``implicitbvh_tpu/volumes.py``.  The public layout is the
JAX package's: each coordinate is its own ``(N,)`` tensor (a 3-tuple), and
constructors also accept ``(N, 3)`` arrays.  The two volume types, their
constructors from triangles, the merge monoid of the tree build, and the
predicates ``iscontact`` (volume against volume) and ``isintersection``
(ray against volume).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from . import tracing
from .utils import as_tensor

Coords = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def as_coords(x, device=None) -> Coords:
    """Normalise an ``(..., 3)`` array or a 3-sequence of arrays to a
    coordinate 3-tuple of tensors (device rules as in ``utils.as_tensor``)."""
    if isinstance(x, (tuple, list)):
        if len(x) != 3:
            raise ValueError(
                f"coordinate tuple must have 3 entries, got {len(x)}")
        return tuple(as_tensor(v, device=device) for v in x)
    x = as_tensor(x, device=device)
    if x.shape[-1] != 3:
        raise ValueError(f"expected trailing dimension 3, got shape {x.shape}")
    return (x[..., 0], x[..., 1], x[..., 2])


def dot3(a: Coords, b: Coords):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's vectorised CPU ``sqrt`` for
    float32 may miss by one ulp; the float64 root rounded back to float32 is
    exact (53 >= 2 * 24 + 2 bits), as IEEE ``sqrtf`` on the card is."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dist3sq(a: Coords, b: Coords):
    d0, d1, d2 = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    return d0 * d0 + d1 * d1 + d2 * d2


def dist3(a: Coords, b: Coords):
    return sqrt_rn(dist3sq(a, b))


def _map3(f, *cs):
    return tuple(f(*[c[k] for c in cs]) for k in range(3))


@dataclasses.dataclass(frozen=True)
class BSphere:
    """Bounding spheres: centre coordinate tuple ``xs`` and radii ``r``."""

    xs: Coords
    r: torch.Tensor

    def __init__(self, xs, r, device=None):
        xs = as_coords(xs, device)
        object.__setattr__(self, "xs", xs)
        object.__setattr__(self, "r", as_tensor(r, device=xs[0].device))

    @property
    def dtype(self):
        return self.r.dtype

    @property
    def device(self):
        return self.r.device

    @property
    def batch_shape(self):
        return tuple(self.r.shape)

    def __getitem__(self, idx):
        return BSphere(tuple(c[idx] for c in self.xs), self.r[idx])


@dataclasses.dataclass(frozen=True)
class BBox:
    """Axis-aligned boxes: lower and upper corner coordinate tuples."""

    los: Coords
    ups: Coords

    def __init__(self, lo, up, device=None):
        los = as_coords(lo, device)
        object.__setattr__(self, "los", los)
        object.__setattr__(self, "ups", as_coords(up, los[0].device))

    @property
    def dtype(self):
        return self.los[0].dtype

    @property
    def device(self):
        return self.los[0].device

    @property
    def batch_shape(self):
        return tuple(self.los[0].shape)

    def __getitem__(self, idx):
        return BBox(tuple(c[idx] for c in self.los),
                    tuple(c[idx] for c in self.ups))


Volume = Union[BSphere, BBox]


def center_coords(v: Volume) -> Coords:
    """Geometric centre coordinate tuple."""
    if isinstance(v, BSphere):
        return v.xs
    return _map3(lambda lo, up: 0.5 * (lo + up), v.los, v.ups)


def center(v: Volume) -> torch.Tensor:
    """Geometric centres as an (..., 3) tensor (public convenience; internal
    code uses :func:`center_coords`, the coordinate tuple)."""
    return torch.stack(center_coords(v), dim=-1)


def bbox_of_bsphere(a: BSphere) -> BBox:
    """Sphere -> enclosing box."""
    return BBox(tuple(c - a.r for c in a.xs), tuple(c + a.r for c in a.xs))


def _select3(b_in_a, a_in_b, xa: Coords, xb: Coords, other: Coords) -> Coords:
    """``xa`` where sphere b lies in a, else ``xb`` where a lies in b, else
    ``other``, per coordinate."""
    return tuple(torch.where(b_in_a, xa[k], torch.where(a_in_b, xb[k],
                                                        other[k]))
                 for k in range(3))


def merge_bspheres(a: BSphere, b: BSphere) -> BSphere:
    """Enclosure-aware sphere + sphere merge: the enclosing sphere when one
    holds the other, else the smallest sphere around both
    (``implicitbvh_tpu/volumes.py:237-251``, same operation order).  Not
    associative."""
    length = dist3(a.xs, b.xs)
    a_in_b = length + a.r <= b.r
    b_in_a = length + b.r <= a.r
    len_safe = torch.where(length == 0.0, torch.ones_like(length), length)
    frac = 0.5 * ((b.r - a.r) / len_safe + 1.0)
    cen = tuple(a.xs[k] + frac * (b.xs[k] - a.xs[k]) for k in range(3))
    rad = 0.5 * (length + a.r + b.r)
    rad = torch.where(b_in_a, a.r, torch.where(a_in_b, b.r, rad))
    return BSphere(_select3(b_in_a, a_in_b, a.xs, b.xs, cen), rad)


def merge_bboxes(a: BBox, b: BBox) -> BBox:
    return BBox(_map3(torch.minimum, a.los, b.los),
                _map3(torch.maximum, a.ups, b.ups))


def merge(a: Volume, b: Volume) -> Volume:
    """Merge two bounding volumes of the same kind (the tree build's
    monoid)."""
    if isinstance(a, BSphere) and isinstance(b, BSphere):
        return merge_bspheres(a, b)
    if isinstance(a, BBox) and isinstance(b, BBox):
        return merge_bboxes(a, b)
    raise TypeError(f"cannot merge {type(a)} with {type(b)}")


def bbox_of_two_bspheres(a: BSphere, b: BSphere) -> BBox:
    """Enclosure-aware sphere + sphere -> box: the enclosing sphere's box
    when one sphere holds the other, else the union of both boxes."""
    length = dist3(a.xs, b.xs)
    a_in_b = length + a.r <= b.r
    b_in_a = length + b.r <= a.r
    boxa, boxb = bbox_of_bsphere(a), bbox_of_bsphere(b)
    lo = _map3(torch.minimum, boxa.los, boxb.los)
    up = _map3(torch.maximum, boxa.ups, boxb.ups)
    return BBox(_select3(b_in_a, a_in_b, boxa.los, boxb.los, lo),
                _select3(b_in_a, a_in_b, boxa.ups, boxb.ups, up))


def convert_volume(kind, v: Volume) -> Volume:
    """Convert a volume to ``kind`` (leaf -> node type conversion)."""
    if isinstance(v, kind):
        return v
    if kind is BBox and isinstance(v, BSphere):
        return bbox_of_bsphere(v)
    raise TypeError(f"cannot convert {type(v)} to {kind}")


def merge_into(kind, a: Volume, b: Volume) -> Volume:
    """Merge two leaf volumes into a node volume of type ``kind``."""
    if kind is BBox and isinstance(a, BSphere) and isinstance(b, BSphere):
        return bbox_of_two_bspheres(a, b)
    return merge(convert_volume(kind, a), convert_volume(kind, b))


def iscontact(a: Volume, b: Volume):
    """Touch/overlap test of two broadcastable volume batches; returns a
    bool tensor.  Spheres: ``dist3sq <= (ra + rb)^2``; boxes: interval
    overlap on every axis; a sphere against a box goes through the
    sphere's box.  These are the formulas of the ``sphere`` and ``box``
    masks of ``ops/tile_contact.py``."""
    if isinstance(a, BSphere) and isinstance(b, BSphere):
        rr = a.r + b.r
        return dist3sq(a.xs, b.xs) <= rr * rr
    if isinstance(a, BBox) and isinstance(b, BBox):
        out = (a.ups[0] >= b.los[0]) & (a.los[0] <= b.ups[0])
        out = out & (a.ups[1] >= b.los[1]) & (a.los[1] <= b.ups[1])
        return out & (a.ups[2] >= b.los[2]) & (a.los[2] <= b.ups[2])
    if isinstance(a, BSphere):
        return iscontact(bbox_of_bsphere(a), b)
    return iscontact(a, bbox_of_bsphere(b))


def _min2(x, y):
    """The reference's select minimum ``where(x < y, x, y)``: a NaN in
    either operand gives ``y`` (``torch.minimum`` would give NaN)."""
    return torch.where(x < y, x, y)


def _max2(x, y):
    """The reference's select maximum ``where(x > y, x, y)``."""
    return torch.where(x > y, x, y)


def _ray_box_test(p, inv, lo, up):
    """Forward-ray slab test from origins ``p``, direction reciprocals
    ``inv`` and box corners ``lo``/``up`` (3-sequences of broadcastable
    tensors), in the reference's operation order."""
    tmin = tmax = None
    for k in range(3):
        t1 = (lo[k] - p[k]) * inv[k]
        t2 = (up[k] - p[k]) * inv[k]
        lo_k, hi_k = _min2(t1, t2), _max2(t1, t2)
        tmin = lo_k if tmin is None else _max2(tmin, lo_k)
        tmax = hi_k if tmax is None else _min2(tmax, hi_k)
    return (tmin <= tmax) & (tmax >= 0)


def _ray_sphere_test(p, d, xs, r):
    """Forward-ray discriminant test of rays ``p``/``d`` against spheres
    ``xs``/``r``, in the reference's operation order."""
    qa = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    po = [p[k] - xs[k] for k in range(3)]
    qb = 2.0 * (po[0] * d[0] + po[1] * d[1] + po[2] * d[2])
    qc = po[0] * po[0] + po[1] * po[1] + po[2] * po[2] - r * r
    disc = qb * qb - 4.0 * qa * qc
    return (disc >= 0) & ((qb <= 0) | (qc <= 0))


def _reciprocal(d):
    """``1 / d`` as an IEEE division (not an approximate reciprocal)."""
    return torch.ones_like(d) / d


def isintersection(v: Volume, p, d):
    """Forward-ray intersection test against boxes (slab test) or spheres
    (discriminant test).  ``p``/``d`` are (..., 3) arrays or coordinate
    tuples, broadcast against the volume batch; returns a bool tensor.

    The JAX package's predicate operation for operation
    (``implicitbvh_tpu/volumes.py:332-370``), in the formulas the ray masks
    of ``ops/tile_contact.py`` share: the slab test takes its
    minima and maxima by ``where(x < y, x, y)``, whose answer on a NaN (a
    ray in a face plane with a zero direction component, ``0 * inf``)
    differs from ``torch.minimum``'s, and ``1 / d`` is an IEEE division.
    """
    dev = v.device
    p, d = as_coords(p, dev), as_coords(d, dev)
    if isinstance(v, BBox):
        return _ray_box_test(p, [_reciprocal(c) for c in d], v.los, v.ups)
    return _ray_sphere_test(p, d, v.xs, v.r)


def bbox_from_triangles(p1, p2, p3, device=None) -> BBox:
    """AABBs of triangles given three ``(N, 3)`` vertex arrays or coordinate
    tuples."""
    a = as_coords(p1, device)
    b = as_coords(p2, a[0].device)
    c = as_coords(p3, a[0].device)
    lo = _map3(lambda x, y, z: torch.minimum(torch.minimum(x, y), z), a, b, c)
    up = _map3(lambda x, y, z: torch.maximum(torch.maximum(x, y), z), a, b, c)
    return BBox(lo, up)


def from_triangles(kind, p1, p2, p3, device=None) -> Volume:
    """``kind`` (the BSphere or BBox class) of triangles."""
    if kind is BSphere:
        return bsphere_from_triangles(p1, p2, p3, device)
    if kind is BBox:
        return bbox_from_triangles(p1, p2, p3, device)
    raise TypeError(f"unknown volume kind {kind}")


def bsphere_from_triangles(p1, p2, p3, device=None) -> BSphere:
    """Minimal bounding spheres of triangles given three ``(N, 3)`` vertex
    arrays or coordinate tuples.

    The Ericson circumsphere with its collinear and obtuse cases, selected
    in the JAX package's order with the same float operation order, so the
    spheres agree bit for bit (``implicitbvh_tpu/volumes.py:163-212``).
    """
    a = as_coords(p1, device)
    with tracing.span("spheres", a[0].device):
        b = as_coords(p2, a[0].device)
        c = as_coords(p3, a[0].device)
        ab = _map3(lambda x, y: y - x, a, b)
        ac = _map3(lambda x, y: y - x, a, c)
        abab = dot3(ab, ab)
        abac = dot3(ab, ac)
        acac = dot3(ac, ac)
        d = 2.0 * (abab * acac - abac * abac)
        flat = d.abs() <= torch.finfo(d.dtype).eps

        # collinear: centre of the three points' AABB
        lo = _map3(lambda x, y, z: torch.minimum(torch.minimum(x, y), z),
                   a, b, c)
        up = _map3(lambda x, y, z: torch.maximum(torch.maximum(x, y), z),
                   a, b, c)
        c_lin = _map3(lambda l, u: 0.5 * (l + u), lo, up)
        r_lin = dist3(c_lin, up)

        d_safe = torch.where(flat, torch.ones_like(d), d)
        s = (abab * acac - acac * abac) / d_safe
        t = (acac * abab - abab * abac) / d_safe

        c_s0 = _map3(lambda x, y: 0.5 * (x + y), a, c)
        c_t0 = _map3(lambda x, y: 0.5 * (x + y), a, b)
        c_st = _map3(lambda x, y: 0.5 * (x + y), b, c)
        c_in = tuple(a[k] + s * ab[k] + t * ac[k] for k in range(3))

        cases = (  # later entries take precedence, as in the JAX selection
            (s + t >= 1.0, c_st, dist3(c_st, b)),
            (t <= 0.0, c_t0, dist3(c_t0, a)),
            (s <= 0.0, c_s0, dist3(c_s0, a)),
            (flat, c_lin, r_lin),
        )
        cen, rad = c_in, dist3(c_in, a)
        for cond, cc, rc in cases:
            cen = _map3(lambda x, y: torch.where(cond, y, x), cen, cc)
            rad = torch.where(cond, rc, rad)
        return BSphere(cen, rad)
