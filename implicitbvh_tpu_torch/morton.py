"""Morton (Z-order) encoding of bounding-volume centers.

Counterpart of ``implicitbvh_tpu/morton.py``: the canonical 3D
bit-interleave with 5/10/21 bits per axis for 16/32/64-bit codes, the
epsilon-expanded extrema, ``morton_encode_single`` and the extended Morton
order, all on the centres' device with no host sync.  Codes are held in
int64 for every width, as the unsigned code's bit pattern: a 64-bit
extended code may set bit 63, and ``build`` sorts on the unsigned order.
The JAX package's (hi, lo) uint32 pair has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

MORTON_SCALING = {16: 2 ** 5, 32: 2 ** 10, 64: 2 ** 21}

# relative precision that expands the extrema (ref default.jl:179-181)
RELATIVE_PRECISION = {
    torch.float16: 1e-2,
    torch.bfloat16: 1e-2,
    torch.float32: 1e-5,
    torch.float64: 1e-14,
}

# per-width magic-mask cascades (ref default.jl:118-157): (shift, mask) steps
# after masking the input to its low bits
_SPLIT3 = {
    16: (0x001F, ((8, 0x100F), (4, 0x10C3), (2, 0x1249))),
    32: (0x03FF, ((16, 0x30000FF), (8, 0x0300F00F), (4, 0x30C30C3),
                  (2, 0x9249249))),
    64: (0x1FFFFF, ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                    (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                    (2, 0x1249249249249249))),
}


def morton_split3(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Spread an integer's low bits two apart for 3D interleaving (int64)."""
    if bits not in _SPLIT3:
        raise ValueError(f"unsupported morton width {bits}")
    low, steps = _SPLIT3[bits]
    s = v.to(torch.int64) & low
    for shift, mask in steps:
        s = (s | (s << shift)) & mask
    return s


def bounding_volumes_extrema(centers):
    """Exclusive (mins, maxs) bounds of a coordinate tuple of (N,) tensors,
    expanded by the float type's relative precision so every quantized
    coordinate lies strictly inside [0, 1).  Returns two 3-tuples of 0-dim
    tensors."""
    dt = centers[0].dtype
    # Python scalars: an op rounds them to the tensors' type, as a 0-dim
    # tensor of that type would, and nothing is copied to the device (a
    # host-to-device copy is a host sync)
    rp = RELATIVE_PRECISION[dt]
    tiny = torch.finfo(dt).tiny
    mins = tuple(c.min() - rp * c.min().abs() - tiny for c in centers)
    maxs = tuple(c.max() + rp * c.max().abs() + tiny for c in centers)
    return mins, maxs


@dataclasses.dataclass(frozen=True)
class MortonAlgorithm:
    """Base class for Morton encoding algorithms."""


@dataclasses.dataclass(frozen=True)
class DefaultMortonAlgorithm(MortonAlgorithm):
    """Canonical 3D bit-interleave (ref src/morton/default.jl:21-40).

    ``bits`` selects the code width (16/32/64).  With
    ``compute_extrema=False`` the fixed ``mins``/``maxs`` bounds are used.
    """

    bits: int = 32
    compute_extrema: bool = True
    mins: Tuple[float, float, float] = (float("nan"),) * 3
    maxs: Tuple[float, float, float] = (float("nan"),) * 3

    def __post_init__(self):
        if self.bits not in (16, 32, 64):
            raise ValueError(f"morton bits must be 16/32/64, got {self.bits}")


def _quantize(c, mn, mx, scaling: int):
    scaled = (c - mn) / (mx - mn)
    # truncation toward zero, like the reference's unsafe_trunc
    return (scaled * float(scaling)).to(torch.int64)


def _extrema(centers, alg):
    """The algorithm's (mins, maxs): computed from the centres, or its
    fixed bounds as 0-dim tensors of the centres' type (filled on the
    device, not copied from the host)."""
    if alg.compute_extrema:
        return bounding_volumes_extrema(centers)
    dt, dev = centers[0].dtype, centers[0].device
    return tuple(tuple(torch.full((), m, dtype=dt, device=dev) for m in ms)
                 for ms in (alg.mins, alg.maxs))


def morton_encode(centers, alg: DefaultMortonAlgorithm) -> torch.Tensor:
    """Morton codes (int64, (N,)) of centers given as a coordinate tuple."""
    mins, maxs = _extrema(centers, alg)
    scaling = MORTON_SCALING[alg.bits]
    s = [morton_split3(_quantize(centers[k], mins[k], maxs[k], scaling),
                       alg.bits) for k in range(3)]
    return (s[0] << 2) | (s[1] << 1) | s[2]


def morton_encode_single(center, mins, maxs, alg: DefaultMortonAlgorithm,
                         device=None) -> torch.Tensor:
    """Code (0-dim int64) of one (3,) centre between explicit bounds,
    through :func:`morton_encode` at ``alg.bits``."""
    from .utils import as_tensor
    c = as_tensor(center, torch.float32, device).reshape(3)
    sub = DefaultMortonAlgorithm(bits=alg.bits, compute_extrema=False,
                                 mins=tuple(map(float, mins)),
                                 maxs=tuple(map(float, maxs)))
    return morton_encode(tuple(c[k:k + 1] for k in range(3)), sub)[0]


# --------------------------------------------------------------------------
# Extended Morton codes (Vinkler, Bittner & Havran, HPG 2017)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExtendedMortonAlgorithm(MortonAlgorithm):
    """Extended Morton codes: adaptive axis order, variable bits per axis
    from repeated longest-axis splits, and optional primitive-size bits
    (ref src/morton/extended.jl).  Defaults per code width:
    ``size_interval``/``size_budget``/``use_sqrt_size`` = (0, 0, off) for
    16-bit, (7, 4, on) for 32-bit, (7, 6, on) for 64-bit: every 7th code
    bit holds quantized primitive extent, up to the budget.  Each axis
    holds at most 24 bits, so its float32 quantization is exact.
    """

    bits: int = 32
    compute_extrema: bool = True
    mins: Tuple[float, float, float] = (float("nan"),) * 3
    maxs: Tuple[float, float, float] = (float("nan"),) * 3
    size_interval: int = -1      # -1 -> per-width default
    size_budget: int = -1
    use_sqrt_size: int = -1      # -1 -> default (interval >= 7)

    def __post_init__(self):
        if self.bits not in (16, 32, 64):
            raise ValueError(f"morton bits must be 16/32/64, got {self.bits}")
        interval = self.size_interval
        if interval < 0:
            interval = 0 if self.bits == 16 else 7
        budget = self.size_budget
        if budget < 0:
            budget = {16: 0, 32: 4, 64: 6}[self.bits]
        budget = min(budget, self.bits // interval) if interval > 0 else 0
        sqrt_flag = self.use_sqrt_size
        if sqrt_flag < 0:
            sqrt_flag = 1 if interval >= 7 else 0
        if budget == 0:
            sqrt_flag = 0
        object.__setattr__(self, "size_interval", interval)
        object.__setattr__(self, "size_budget", budget)
        object.__setattr__(self, "use_sqrt_size", sqrt_flag)

    @property
    def size_slots(self):
        """0-based code-bit positions holding size bits: every
        ``size_interval``-th slot (1-based) up to the budget."""
        if self.size_interval <= 0 or self.size_budget <= 0:
            return ()
        slots = [idx - 1 for idx in range(1, self.bits + 1)
                 if idx % self.size_interval == 0]
        return tuple(slots[:self.size_budget])


_AXIS_BIT_CAP = 24   # float32-exact quantization ceiling per axis
_EPS32 = float(np.finfo(np.float32).eps)
_TINY32 = float(np.finfo(np.float32).tiny)   # the TPU flushes below it
_LN2_32 = float(np.float32(np.log(2.0)))


def _exp2_f32(counts) -> torch.Tensor:
    """``exp2`` of integer counts (a tensor, or a numpy array on the CPU)
    as the JAX package computes it in float32: the exponential of ``counts
    * ln2`` (a float32 product) rounded to float32, which is not exact
    above 2^12 (2^21 comes out as 2^21 + 1).  The float64 exponential
    rounded to float32 gives the same value at every count 0..24."""
    arg = torch.as_tensor(counts).to(torch.float32) * _LN2_32
    return torch.exp(arg.double()).float()


def _extended_schedule(ranges, alg: ExtendedMortonAlgorithm):
    """The longest-axis split schedule as the JAX package writes it, a
    greedy loop over the code bits, here in numpy float32 on the host:
    returns ``(axes, counts)``, ``axes`` a list with one entry per code bit
    (MSB first), an axis 0..2 or ``"size"``, and ``counts`` the (3,) int32
    bits per axis.  The first maximum wins a tie; with no eligible axis the
    choice cycles from ``i % 3``, skipping capped axes.  A length below
    float32's smallest normal counts as 0, as the TPU flushes it.  The build
    runs :func:`_schedule`, the same schedule on the device without a loop;
    the tests hold one against the other."""
    size_slots = set(alg.size_slots)
    lengths = np.abs(np.asarray(ranges, np.float32))
    lengths = np.where(lengths < _TINY32, np.float32(0), lengths)
    counts = np.zeros(3, np.int32)
    axes = []
    for i in range(alg.bits):
        if i in size_slots:
            axes.append("size")
            continue
        eligible = counts < _AXIS_BIT_CAP
        le = np.where(eligible & np.isfinite(lengths) & (lengths > 0),
                      lengths, np.float32(-np.inf))
        ax = int(np.argmax(le))
        if not le[ax] > -np.inf:
            ax = next((a for a in (i % 3, (i + 1) % 3) if eligible[a]),
                      (i + 2) % 3)
        counts[ax] += 1
        lengths[ax] = lengths[ax] * np.float32(0.5)
        if lengths[ax] < _TINY32:
            lengths[ax] = 0
        axes.append(ax)
    return axes, counts


def _schedule(rng: torch.Tensor, alg: ExtendedMortonAlgorithm):
    """:func:`_extended_schedule` on the device, without a loop over the
    code bits and without a host sync.  ``rng`` is the (3,) float32 tensor
    of scene ranges.  Returns, per code bit (MSB first), its source row
    ``src`` (an axis 0..2, or 3 for a size bit) and ``shift`` (the bit of
    that row's quantized value it takes), and ``counts``, the (3,) int64
    bits per axis.

    The loop halves an axis's length each time it takes it, exactly down
    to the smallest normal, below which it flushes to 0; so its j-th
    length of an axis is ``len * 2^-j`` rounded once and flushed.  It takes
    the longest eligible length, the lower axis on a tie, at most 24 times
    an axis: its order over the positive finite lengths is a descending
    stable sort of the (3, 24) table of them, laid out axis by axis, and
    the axis bits take that order.  Past it, no eligible axis has a
    positive finite length and the loop's fallback takes the rest: the
    first uncapped axis from ``i % 3``.  That choice changes only when an
    axis reaches the cap, at most twice, so three passes, each up to the
    next cap, place it."""
    dev, cap, n = rng.device, _AXIS_BIT_CAP, alg.bits
    i = torch.arange(n, device=dev)
    size = (i + 1) % max(alg.size_interval, 1) == 0
    size &= i < alg.size_interval * len(alg.size_slots)
    axis_bit = ~size
    t = axis_bit.cumsum(0) - 1                   # rank among the axis bits
    j = torch.arange(cap, device=dev)
    half = (torch.ones_like(j) << (cap - 1 - j)).float() * 2.0 ** (1 - cap)
    lengths = rng.abs()[:, None] * half          # (3, cap): len * 2^-j
    key = torch.where(torch.isfinite(lengths) & (lengths >= _TINY32),
                      lengths, -1.0).reshape(-1)
    order = torch.sort(key, descending=True, stable=True).indices
    merged = axis_bit & (t < (key > 0).sum())
    ax = (order // cap)[t.clamp(min=0)]
    three = torch.arange(3, device=dev)
    counts = ((ax[:, None] == three) & merged[:, None]).sum(0)

    fallback = axis_bit & ~merged
    p0, p1, p2 = i % 3, (i + 1) % 3, (i + 2) % 3
    start = torch.zeros_like(counts[0])
    for _ in range(3):
        capped = counts >= cap
        choice = torch.where(capped[p0], torch.where(capped[p1], p2, p1), p0)
        live = fallback & (i >= start)
        pick = (choice[:, None] == three) & live[:, None]
        after = counts + pick.cumsum(0)          # counts after each bit
        full = live & (after.gather(1, choice[:, None])[:, 0] == cap)
        end = torch.where(full, i, n).min()
        take = live & (i <= end)
        ax = torch.where(take, choice, ax)
        counts = counts + (pick & take[:, None]).sum(0)
        start = end + 1

    # each axis bit takes the next most significant unconsumed bit of its
    # axis's quantized value, each size bit the next of the size value
    mine = ((ax[:, None] == three) & axis_bit[:, None]).cumsum(0)
    shift = torch.where(size, len(alg.size_slots) - size.cumsum(0),
                        counts[ax] - mine.gather(1, ax[:, None])[:, 0])
    return torch.where(size, 3, ax), shift, counts


def _quantize_extended(v, mn, scale, maxv) -> torch.Tensor:
    """``(v - mn) * scale`` truncated toward zero and clamped to
    ``[0, maxv]`` (int64); a non-finite or negative value gives 0."""
    enc = (v - mn) * scale
    enc = torch.where(torch.isfinite(enc) & (enc >= 0), enc, 0.0)
    return enc.clamp(max=maxv).to(torch.int64)


def morton_encode_extended(volume, alg: ExtendedMortonAlgorithm
                           ) -> torch.Tensor:
    """Extended Morton codes (int64, (N,)) of a batch of volumes (the size
    bits need the whole volume, not only its centres).

    Runs on the volumes' device with no host sync: :func:`_schedule` gives
    each code bit's source and shift from the three scene ranges, and the
    assembly is one gather from the stacked quantized values, shifted into
    place and summed.  A 64-bit code may set bit 63; it is held as the
    unsigned code's bit pattern (negative as int64).
    """
    from .volumes import BSphere, center_coords, sqrt_rn
    centers = center_coords(volume)
    mins, maxs = _extrema(centers, alg)
    rng = torch.stack([(mx - mn).abs() for mn, mx in zip(mins, maxs)])
    rng = rng.to(torch.float32)
    src, shift, counts = _schedule(rng, alg)
    maxv = _exp2_f32(counts) - 1.0
    scales = torch.where((counts > 0) & (rng > _EPS32) & torch.isfinite(rng),
                         maxv / rng.clamp(min=_EPS32), 0.0)
    q = [_quantize_extended(centers[k].to(torch.float32),
                            mins[k].to(torch.float32), scales[k], maxv[k])
         for k in range(3)]

    # size bits: quantized volume diagonal (2r for spheres), optionally
    # under a square root, over the scene diagonal
    c4 = len(alg.size_slots)
    if c4 > 0:
        if isinstance(volume, BSphere):
            diag = 2.0 * volume.r.to(torch.float32)
        else:
            d = [(volume.ups[k] - volume.los[k]).to(torch.float32)
                 for k in range(3)]
            diag = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        denom = sqrt_rn(rng[0] * rng[0] + rng[1] * rng[1] + rng[2] * rng[2])
        measure = diag.clamp(min=0.0)
        if alg.use_sqrt_size:
            denom, measure = sqrt_rn(denom), sqrt_rn(measure)
        maxv4 = float((1 << c4) - 1)
        size_scale = torch.where(torch.isfinite(denom) & (denom > _EPS32),
                                 maxv4 / denom, 0.0)
        q.append(_quantize_extended(measure, 0.0, size_scale, maxv4))

    pos = torch.arange(alg.bits - 1, -1, -1, device=rng.device)
    bits = (torch.stack(q)[src] >> shift[:, None]) & 1
    # the terms are disjoint bits; bit 63's is -2^63, and a sum that adds
    # it to bits below 63 cannot overflow
    return (bits << pos[:, None]).sum(0)
