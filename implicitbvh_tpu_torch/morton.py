"""Morton (Z-order) encoding of bounding-volume centers.

Counterpart of ``implicitbvh_tpu/morton.py:41-198``: the canonical 3D
bit-interleave with 5/10/21 bits per axis for 16/32/64-bit codes and the
epsilon-expanded extrema.  Codes are held in int64 for every width: the
63-bit code fits a signed int64 and sorts correctly there, so the JAX
package's (hi, lo) uint32 pair has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


def morton_encode(centers, alg: DefaultMortonAlgorithm) -> torch.Tensor:
    """Morton codes (int64, (N,)) of centers given as a coordinate tuple."""
    dt = centers[0].dtype
    dev = centers[0].device
    if alg.compute_extrema:
        mins, maxs = bounding_volumes_extrema(centers)
    else:
        mins = tuple(torch.tensor(m, dtype=dt, device=dev) for m in alg.mins)
        maxs = tuple(torch.tensor(m, dtype=dt, device=dev) for m in alg.maxs)
    scaling = MORTON_SCALING[alg.bits]
    s = [morton_split3(_quantize(centers[k], mins[k], maxs[k], scaling),
                       alg.bits) for k in range(3)]
    return (s[0] << 2) | (s[1] << 1) | s[2]
