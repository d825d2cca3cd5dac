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


# --------------------------------------------------------------------------
# Child index arithmetic for BVTT sprouting (ref: src/utils.jl:98-106)
# --------------------------------------------------------------------------

def leftleft(i1, i2):
    return i1 * 2, i2 * 2


def leftright(i1, i2):
    return i1 * 2, i2 * 2 + 1


def rightleft(i1, i2):
    return i1 * 2 + 1, i2 * 2


def rightright(i1, i2):
    return i1 * 2 + 1, i2 * 2 + 1


def leftnoop(i1, i2):
    return i1 * 2, i2


def rightnoop(i1, i2):
    return i1 * 2 + 1, i2


def noopleft(i1, i2):
    return i1, i2 * 2


def noopright(i1, i2):
    return i1, i2 * 2 + 1


# --------------------------------------------------------------------------
# Upper-triangle pair unranking (ref: src/utils.jl:202-275)
# --------------------------------------------------------------------------
# A linear index k maps to the (i, j) upper-triangle pair in lexicographic
# block order: the initial BVTT all-pairs frontier in one vector op per
# element.  The JAX package computes in the dtype of k; here the search runs
# in int64 and the result is cast back, because ``s_before`` reaches about
# n^2 and passes 2^31 once n passes 46,340 (where int32 arithmetic wraps).

def _block_search(s_before, n_blocks, k):
    """Largest i in [0, n_blocks) with s_before(i) <= k, by a branch-free
    binary search of 31 fixed steps.  ``n_blocks``: a Python int or a
    tensor broadcastable to ``k``."""
    lo = torch.zeros_like(k)
    if isinstance(n_blocks, torch.Tensor):
        hi = (n_blocks - 1).to(k.dtype).expand_as(k).clone()
    else:
        hi = torch.full_like(k, n_blocks - 1)
    for _ in range(31):
        mid = (lo + hi + 1) >> 1
        go_up = s_before(mid) <= k
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid - 1)
    return lo


def k2ij_inclusive(n, k):
    """Unrank the 0-based inclusive upper-triangle index k -> (i, j),
    0 <= i <= j < n, in the dtype of ``k``.

    Order: (0,0),(0,1),..,(0,n-1),(1,1),..,(n-1,n-1).
    """
    k64 = k.to(torch.int64)

    def s_before(t):
        return t * n - (t * (t - 1)) // 2

    i = _block_search(s_before, n, k64)
    j = i + (k64 - s_before(i))
    return i.to(k.dtype), j.to(k.dtype)


def k2ij_exclusive(n, k):
    """Unrank the 0-based exclusive upper-triangle index k -> (i, j),
    0 <= i < j < n, in the dtype of ``k``.

    Order: (0,1),..,(0,n-1),(1,2),..,(n-2,n-1).
    """
    k64 = k.to(torch.int64)

    def s_before(t):
        return (t * (2 * n - t - 1)) // 2

    n_blocks = torch.clamp(n - 1, min=1) if isinstance(n, torch.Tensor) \
        else max(n - 1, 1)
    i = _block_search(s_before, n_blocks, k64)
    j = i + 1 + (k64 - s_before(i))
    return i.to(k.dtype), j.to(k.dtype)
