"""Static integer helpers and the port's device rules.

Counterpart of ``implicitbvh_tpu/utils.py``: the static half (tree shapes
are plain Python integers), the per-lane bit helpers of the tree walk
(``floor_ilog2``, ``count_trailing_zeros``, ``trailing_ones`` on integer
tensors), and the device policy every entry point follows:

- numpy arrays and Python values go to ``device`` if the caller names one,
  else to ``"cuda"``;
- torch tensors stay on their own device unless the caller names another;
- asking for CUDA on a machine without a GPU raises: nothing silently runs on
  the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def ilog2_static(n: int, round_up: bool = False) -> int:
    """Integer log2 (ref: src/utils.jl:111-133)."""
    if n < 1:
        raise ValueError(f"ilog2 domain error: {n}")
    f = n.bit_length() - 1
    if round_up and (n & (n - 1)) != 0:
        return f + 1
    return f


def resolve_device(device=None, *likes) -> torch.device:
    """The device an entry point works on: ``device`` if given, else that of
    the first torch tensor among ``likes``, else CUDA."""
    if device is None:
        for x in likes:
            if isinstance(x, torch.Tensor):
                return x.device
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or CPU tensors) "
            "to run the port on the CPU")
    return device


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (resolved as in :func:`resolve_device`)."""
    dev = resolve_device(device, x)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    if dtype is None and isinstance(x, (float, list, tuple)):
        dtype = torch.float32
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def floor_ilog2(v: torch.Tensor) -> torch.Tensor:
    """``floor(log2(v))`` of a positive int32/int64 tensor, in its dtype:
    the exponent of the value as a float64, which holds every integer below
    2^53 exactly."""
    return (torch.frexp(v.to(torch.float64)).exponent - 1).to(v.dtype)


def count_trailing_zeros(v: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of a positive integer tensor: the position of its
    lowest set bit."""
    return floor_ilog2((v & -v).clamp(min=1))


def trailing_ones(v: torch.Tensor) -> torch.Tensor:
    """Trailing one bits of ``v``: the right-child edges a stackless walk
    climbs from node ``v``."""
    return count_trailing_zeros(v + 1)
