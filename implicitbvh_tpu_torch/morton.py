"""Morton (Z-order) encoding of bounding-volume centers.

Counterpart of ``implicitbvh_tpu/morton.py``: the canonical 3D
bit-interleave with 5/10/21 bits per axis for 16/32/64-bit codes, the
epsilon-expanded extrema, ``morton_encode_single`` and the extended Morton
order.  Codes are held in int64 for every width, as the unsigned code's bit
pattern: a 64-bit extended code may set bit 63, and ``build`` sorts on the
unsigned order.  The JAX package's (hi, lo) uint32 pair has no counterpart.
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
    fixed bounds as 0-dim tensors of the centres' type."""
    if alg.compute_extrema:
        return bounding_volumes_extrema(centers)
    dt, dev = centers[0].dtype, centers[0].device
    return (tuple(torch.tensor(m, dtype=dt, device=dev) for m in alg.mins),
            tuple(torch.tensor(m, dtype=dt, device=dev) for m in alg.maxs))


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
_EPS32 = np.finfo(np.float32).eps


def _exp2_f32(counts: np.ndarray) -> np.ndarray:
    """``exp2`` of float32 integers as the JAX package computes it: the
    exponential of ``counts * ln2`` rounded to float32, which is not exact
    above 2^12 (2^21 comes out as 2^21 + 1).  The float64 exponential
    rounded to float32 gives the same value at every count 0..24."""
    arg = counts.astype(np.float32) * np.float32(np.log(2.0))
    return np.exp(arg.astype(np.float64)).astype(np.float32)


def _extended_schedule(ranges, alg: ExtendedMortonAlgorithm):
    """Longest-axis split schedule over the code bits, in numpy float32 on
    the host: returns ``(axes, counts)``, ``axes`` a list with one entry per
    code bit (MSB first), an axis 0..2 or ``"size"``, and ``counts`` the
    (3,) int32 bits per axis.  The first maximum wins a tie; with no
    eligible axis the choice cycles from ``i % 3``, skipping capped axes."""
    size_slots = set(alg.size_slots)
    lengths = np.abs(np.asarray(ranges, np.float32))
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
        axes.append(ax)
    return axes, counts


def _quantize_extended(v, mn, scale: float, maxv: float) -> torch.Tensor:
    """``(v - mn) * scale`` truncated toward zero and clamped to
    ``[0, maxv]`` (int64); a non-finite or negative value gives 0."""
    enc = (v - mn) * scale
    enc = torch.where(torch.isfinite(enc) & (enc >= 0), enc, 0.0)
    return enc.clamp(max=maxv).to(torch.int64)


def morton_encode_extended(volume, alg: ExtendedMortonAlgorithm
                           ) -> torch.Tensor:
    """Extended Morton codes (int64, (N,)) of a batch of volumes (the size
    bits need the whole volume, not only its centres).

    The three scene ranges are read to the host once (one sync) and the
    schedule runs there in float32, so the assembly knows each code bit's
    axis and shift: one gather from the stacked (4, N) quantized values by
    the schedule, shifted into place and summed.  A 64-bit code may set bit
    63; it is held as the unsigned code's bit pattern (negative as int64).
    """
    from .volumes import BSphere, center_coords, sqrt_rn
    centers = center_coords(volume)
    mins, maxs = _extrema(centers, alg)
    rng = torch.stack([(mx - mn).abs() for mn, mx in zip(mins, maxs)])
    rng = rng.to(torch.float32).cpu().numpy()

    axes, counts = _extended_schedule(rng, alg)
    c4 = len(alg.size_slots)
    maxv = _exp2_f32(counts) - np.float32(1)
    scales = np.where((counts > 0) & (rng > _EPS32) & np.isfinite(rng),
                      maxv / np.maximum(rng, _EPS32), np.float32(0))
    q = [_quantize_extended(centers[k].to(torch.float32),
                            mins[k].to(torch.float32), float(scales[k]),
                            float(maxv[k])) for k in range(3)]

    # size bits: quantized volume diagonal (2r for spheres), optionally
    # under a square root, over the scene diagonal
    if c4 > 0:
        if isinstance(volume, BSphere):
            diag = 2.0 * volume.r.to(torch.float32)
        else:
            d = [(volume.ups[k] - volume.los[k]).to(torch.float32)
                 for k in range(3)]
            diag = sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        scene_diag = np.sqrt(rng[0] * rng[0] + rng[1] * rng[1]
                             + rng[2] * rng[2])
        maxv4 = float((1 << c4) - 1)
        measure = diag.clamp(min=0.0)
        if alg.use_sqrt_size:
            denom = np.sqrt(scene_diag)
            measure = sqrt_rn(measure)
        else:
            denom = scene_diag
        size_scale = np.float32(maxv4) / denom \
            if np.isfinite(denom) and denom > _EPS32 else np.float32(0)
        q.append(_quantize_extended(measure, 0.0, float(size_scale), maxv4))
    else:
        q.append(torch.zeros_like(q[0]))

    # assembly: bit i of the code (MSB first) takes the next most
    # significant unconsumed bit of its axis's quantized value
    rem = [int(c) for c in counts] + [c4]
    src, shift = [], []
    for ax in axes:
        a = 3 if ax == "size" else ax
        rem[a] -= 1
        src.append(a)
        shift.append(rem[a])
    pos = list(range(alg.bits - 1, -1, -1))
    dev = centers[0].device
    src_t, shift_t, pos_t = (torch.tensor(x, dtype=torch.int64, device=dev)
                             for x in (src, shift, pos))
    bits = (torch.stack(q)[src_t] >> shift_t[:, None]) & 1
    # the terms are disjoint bits; bit 63's is -2^63, and a sum that adds
    # it to bits below 63 cannot overflow
    return (bits << pos_t[:, None]).sum(0)
