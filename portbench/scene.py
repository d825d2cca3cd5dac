"""The benchmark's traffic generator: scenes, their motion and bundles of
rays, all made on the device.

A configuration's ``scene`` names one of two kinds:

- ``closed surface``: a closed genus-0 triangle mesh of exactly
  ``triangles`` faces (any even number), as a scanned model is: each
  vertex is shared by the faces around it, so each triangle's bounding
  sphere touches those of its vertex neighbours.  Vertices lie on rings
  of constant latitude of a star-shaped, smoothly bumped sphere, with ring
  sizes in proportion to the ring's circumference so that edges are about
  ``edge`` long; each strip between two rings is closed by merging the
  rings' vertices by angle, so a mesh of ``V`` vertices has ``2 V - 4``
  faces.  Vertices are then jittered by up to ``0.1 * edge`` per axis.
  The mesh moves by its vertices, so it deforms and never tears.
- ``particles``: ``particles`` spheres, centres uniform in a cube of side
  ``n ** (1/3) * spacing`` (one per ``spacing^3``), radii uniform in
  ``radius`` = ``[lo, hi]``.  A particle moves by its centre.

Points move as ``x(t) = x0 + amplitude * scale * sin(2 pi t / period +
phi) * u``, with a phase ``phi`` and a unit direction ``u`` per point
(``scale`` is the mesh's ``edge`` or the particles' ``spacing``), so the
scene stays near its rest state for any number of steps.  Rays start
uniform in the scene's bounding box, with directions uniform in
``[-0.5, 0.5]^3``.

The scene is the configuration's: drawn from its own ``scene_seed``, the
same in every run, as a deployment's mesh is.  The run's seed draws the
traffic: the order in which the leaves are handed over, their motion and
the rays.  Each draw comes from a ``torch.Generator`` on the device, in a
fixed order, so a seed gives the same inputs on every run.  Everything is
float32 in SoA form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

JITTER = 0.1        # of the edge, per axis
BUMPS = ((2, 3, 0.12), (3, 2, 0.08), (5, 4, 0.04))   # (theta, phi, height)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


@dataclass
class Scene:
    """``points`` (3, m) move; the leaves are made from them: the faces'
    triangles (``faces`` (3, n), indices into the points) or spheres of
    ``radii`` (n,) about them."""
    points: torch.Tensor
    faces: Optional[torch.Tensor] = None
    radii: Optional[torch.Tensor] = None
    scale: float = 1.0

    @property
    def n(self) -> int:
        return self.faces.shape[1] if self.faces is not None else \
            self.radii.shape[0]

    def leaves(self, points: torch.Tensor) -> dict:
        """The reference's leaves at ``points``: ``{"tris": (3 vertices, 3
        coordinates, n)}`` or ``{"x": (3, n), "r": (n,)}``."""
        if self.faces is not None:
            return {"tris": points[:, self.faces].transpose(0, 1)}
        return {"x": points, "r": self.radii}

    def shuffled(self, g: torch.Generator) -> "Scene":
        """The same scene with its leaves in an order drawn from ``g``."""
        perm = torch.randperm(self.n, generator=g, device=self.points.device)
        if self.faces is not None:
            return Scene(self.points, self.faces[:, perm].contiguous(),
                         None, self.scale)
        return Scene(self.points[:, perm].contiguous(), None,
                     self.radii[perm].contiguous(), self.scale)


def ring_sizes(total: int, rings: int) -> list:
    """``rings`` sizes, each at least 3, summing to ``total`` (at least
    ``3 * rings``), in proportion to ``sin`` of the rings' latitudes."""
    w = [math.sin(math.pi * (i + 0.5) / rings) for i in range(rings)]
    share = [total * x / sum(w) for x in w]
    sizes = [max(3, int(s)) for s in share]
    order = sorted(range(rings), key=lambda i: sizes[i] - share[i])
    k = 0
    while sum(sizes) != total:
        i = order[k % rings]
        step = 1 if sum(sizes) < total else -1
        if sizes[i] + step >= 3:
            sizes[i] += step
        k += 1
    return sizes


def surface_faces(sizes: list, offsets: torch.Tensor) -> torch.Tensor:
    """``(3, 2 * sum(sizes))`` int64 faces of the closed mesh whose
    vertices are the north pole (0), the south pole (1) and the rings of
    ``sizes`` in order, ring ``i``'s vertex ``j`` at angle ``2 pi (j +
    offsets[i]) / sizes[i]``."""
    dev = offsets.device
    k = len(sizes)
    size = torch.tensor(sizes, device=dev)
    first = 2 + torch.cumsum(size, 0) - size            # ring's first vertex
    ring = torch.repeat_interleave(torch.arange(k, device=dev), size)
    j = torch.arange(int(size.sum()), device=dev) - first[ring] + 2
    # the angle at which a strip walk steps past vertex j of its ring
    nxt = (2 * math.pi) * (j + 1 + offsets[ring].double()) / size[ring]
    # strip s merges ring s (A) and ring s + 1 (B)
    a = ring < k - 1
    b = ring > 0
    strip = torch.cat([ring[a], ring[b] - 1])
    is_a = torch.cat([torch.ones_like(ring[a], dtype=torch.bool),
                      torch.zeros_like(ring[b], dtype=torch.bool)])
    key = strip.double() * 16.0 + torch.cat([nxt[a], nxt[b]])
    order = torch.sort(key, stable=True).indices
    strip, is_a = strip[order], is_a[order]
    events = size[:-1] + size[1:]
    start = torch.cumsum(events, 0) - events
    ca_all = torch.cumsum(is_a.long(), 0) - is_a.long()
    cb_all = torch.cumsum((~is_a).long(), 0) - (~is_a).long()
    base = start[strip]
    ca = ca_all - torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(is_a.long(), 0)])[base]
    cb = cb_all - torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum((~is_a).long(), 0)])[base]
    sa, sb = size[strip], size[strip + 1]
    fa, fb = first[strip], first[strip + 1]
    va, vb = fa + ca % sa, fb + cb % sb
    third = torch.where(is_a, fa + (ca + 1) % sa, fb + (cb + 1) % sb)
    strips = torch.stack([va, vb, third])
    n0, n1 = sizes[0], sizes[-1]
    t0 = torch.arange(n0, device=dev)
    t1 = torch.arange(n1, device=dev)
    north = torch.stack([torch.zeros_like(t0), first[0] + t0,
                         first[0] + (t0 + 1) % n0])
    south = torch.stack([torch.ones_like(t1), first[-1] + (t1 + 1) % n1,
                         first[-1] + t1])
    return torch.cat([north, strips, south], 1)


def surface(n: int, g: torch.Generator, device, *, edge: float) -> Scene:
    """A closed surface of exactly ``n`` (even) triangles with edges about
    ``edge`` long (module docstring)."""
    if n % 2 or n < 6:
        raise ValueError(f"a closed surface of rings has an even number "
                         f"of faces, at least 6; got {n}")
    total = n // 2
    rings = max(1, min(total // 3, round(math.sqrt(math.pi * total / 4))))
    sizes = ring_sizes(total, rings)
    offsets = torch.rand((rings,), generator=g, device=device)
    phases = torch.rand((len(BUMPS),), generator=g, device=device,
                        dtype=torch.float64) * (2 * math.pi)
    size = torch.tensor(sizes, device=device)
    ring = torch.repeat_interleave(torch.arange(rings, device=device), size)
    first = torch.cumsum(size, 0) - size
    j = torch.arange(total, device=device) - first[ring]
    theta = torch.cat([torch.tensor([0.0, math.pi], device=device,
                                    dtype=torch.float64),
                       math.pi * (ring.double() + 0.5) / rings])
    phi = torch.cat([torch.zeros(2, device=device, dtype=torch.float64),
                     2 * math.pi * (j + offsets[ring].double())
                     / size[ring]])
    rho = torch.ones_like(theta)
    for (kt, kp, h), p in zip(BUMPS, phases):
        rho = rho + h * torch.sin(kt * theta) * torch.cos(kp * phi + p)
    # a sphere of n equilateral faces of side `edge` has this radius
    radius = edge * math.sqrt(n * math.sqrt(3.0) / (16.0 * math.pi))
    st = torch.sin(theta)
    pts = radius * rho * torch.stack([st * torch.cos(phi),
                                      st * torch.sin(phi), torch.cos(theta)])
    jit = torch.rand(pts.shape, generator=g, device=device,
                     dtype=torch.float64)
    pts = pts + (jit - 0.5) * (2 * JITTER * edge)
    return Scene(pts.float().contiguous(), surface_faces(sizes, offsets),
                 None, edge)


def particles(n: int, g: torch.Generator, device, *, spacing: float,
              radius) -> Scene:
    """``n`` particles, centres uniform in a cube of side ``n ** (1/3) *
    spacing``, radii uniform in ``radius``."""
    u = torch.rand((4, n), generator=g, device=device)
    lo, hi = radius
    return Scene((u[:3] * (spacing * float(n) ** (1.0 / 3.0))).contiguous(),
                 None, (lo + (hi - lo) * u[3]).contiguous(), spacing)


def configured(config: dict, seed: int, device):
    """``(scene, generator)``: the configuration's scene (from its
    ``scene_seed``) with its leaves in an order drawn from the run's
    ``seed``, and the run's generator for the rest of its draws."""
    sg = generator(config["scene_seed"], device)
    if config["scene"] == "closed surface":
        base = surface(config["triangles"], sg, device, edge=config["edge"])
    elif config["scene"] == "particles":
        base = particles(config["particles"], sg, device,
                         spacing=config["spacing"], radius=config["radius"])
    else:
        raise ValueError(f"unknown scene {config['scene']!r}")
    g = generator(seed, device)
    return base.shuffled(g), g


def motion(m: int, g: torch.Generator, device):
    """``(phase (m,), direction (3, m))``: a phase in ``[0, 2 pi)`` and a
    unit direction per point."""
    phase = torch.rand((m,), generator=g, device=device) * (2.0 * math.pi)
    u = torch.randn((3, m), generator=g, device=device)
    return phase, u / torch.sqrt((u * u).sum(0))


def moved(points: torch.Tensor, phase: torch.Tensor,
          direction: torch.Tensor, t: torch.Tensor, amplitude: float,
          period: float) -> torch.Tensor:
    """The points at step ``t`` (a 0-dim float32 tensor on the device),
    each shifted along its direction by up to ``amplitude``.  The graph
    cells capture this call; the check calls it again at a step's ``t``,
    which gives the same bits."""
    shift = amplitude * torch.sin(t * (2.0 * math.pi / period) + phase)
    return points + shift * direction


def ray_pool(bundles: int, n_rays: int, points: torch.Tensor,
             g: torch.Generator):
    """``(origins, directions)``, each ``(bundles, 3, n_rays)``: origins
    uniform in the bounding box of ``points``, directions uniform in
    ``[-0.5, 0.5]^3``."""
    lo = points.min(1).values[None, :, None]
    hi = points.max(1).values[None, :, None]
    u = torch.rand((2, bundles, 3, n_rays), generator=g,
                   device=points.device)
    return (lo + u[0] * (hi - lo)).contiguous(), (u[1] - 0.5).contiguous()
