"""The tile engine's W-grouping of a ti-sorted list (leader packing): the
CUDA kernel L1 and its plain version.

The two-phase route packs its run lists (``traverse/tiles.py:
_slice_runs``), its emit lists (``_regroup_emit_runs``, rays included)
and the fallback's pair list (``_group_pairs``) W entries a step, so that
a step shares one a-tile.  The JAX package computes this in XLA glue
(``implicitbvh_tpu/traverse/tiles.py:_leader_group``, ``jax.lax.cummax``
and two cumsums), with no Pallas kernel behind it; :func:`leader_group_plain`
is that chain in torch ops.  On the H100 its scan with indices walks every
padded entry in one block, about 2 ns an entry whatever the live count.
``csrc/leader_group.cu`` computes the same outputs, bit for bit, in two
launches bound by bytes (the note there gives the scan).
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import _build

MAX_PAYLOADS = 32
_TILE = 1024             # the kernel's tile: scratch of 4 ints each


def scatter_drop(size, dst, values, fill):
    """``full(size, fill)`` with ``values`` written at ``dst``; targets
    outside ``[0, size)`` are dropped.  The plain version's scatter, and the
    traverse layer's wherever it packs a list into fixed slots."""
    dst = torch.where((dst >= 0) & (dst < size), dst, size).long()
    out = torch.full((size + 1,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_(0, dst, values)[:size]


def leader_group_plain(ti_flat, valid, payloads, pads, W: int, S_cap: int):
    """Plain PyTorch version of :func:`leader_group`."""
    v = valid.int()
    cv_ex = torch.cumsum(v, 0) - v
    prev = torch.cat([ti_flat.new_full((1,), -1), ti_flat[:-1]])
    run_base = torch.cummax(
        torch.where(ti_flat != prev, cv_ex, -1), 0).values
    posr = cv_ex - run_base
    leader = valid & (posr % W == 0)
    lead_cum = torch.cumsum(leader.int(), 0)
    gid = lead_cum - 1
    nsteps = lead_cum[-1].int()
    a_idx = scatter_drop(S_cap, torch.where(leader, gid, S_cap),
                         ti_flat.int(), 0)
    b_dst = torch.where(valid, gid * W + posr % W, S_cap * W)
    grouped = tuple(scatter_drop(S_cap * W, b_dst, p.int(), pad)
                    for p, pad in zip(payloads, pads))
    return a_idx, grouped, nsteps


def _check_group(ti_flat, valid, payloads, pads, W, S_cap):
    if not isinstance(ti_flat, torch.Tensor) or ti_flat.dtype not in (
            torch.int32, torch.int64):
        got = ti_flat.dtype if isinstance(ti_flat, torch.Tensor) else \
            type(ti_flat).__name__
        raise TypeError(f"ti_flat must be torch.int32 or torch.int64, "
                        f"got {got}")
    E = ti_flat.shape[0] if ti_flat.dim() == 1 else 0
    if E < 1 or E >= 1 << 31:
        raise ValueError(f"ti_flat must be (E,) with 1 <= E < 2^31, got "
                         f"{tuple(ti_flat.shape)}")
    _build.check(ti_flat, "ti_flat", ti_flat.dtype)
    _build.check(valid, "valid", torch.bool, (E,), ti_flat.device)
    if not 1 <= len(payloads) <= MAX_PAYLOADS or len(pads) != len(payloads):
        raise ValueError(f"need 1 to {MAX_PAYLOADS} payloads and a pad "
                         f"each, got {len(payloads)} and {len(pads)}")
    for q, p in enumerate(payloads):
        if not isinstance(p, torch.Tensor) or p.dtype not in (
                torch.int32, torch.int64):
            raise TypeError(f"payloads[{q}] must be torch.int32 or "
                            f"torch.int64")
        if tuple(p.shape) != (E,) or p.device != ti_flat.device:
            raise ValueError(f"payloads[{q}] must be ({E},) on "
                             f"{ti_flat.device}")
    for pad in pads:
        if not -(1 << 31) <= int(pad) < 1 << 31:
            raise ValueError(f"pads must fit int32, got {pad}")
    if W < 1 or S_cap < 1 or (len(payloads) + 1) * S_cap * W >= 1 << 31:
        raise ValueError(f"need W >= 1, S_cap >= 1 and (k + 1) * S_cap * W "
                         f"< 2^31, got W {W}, S_cap {S_cap}")
    return E


def leader_group(ti_flat, valid, payloads, pads, W: int, S_cap: int):
    """Pack the valid entries of a ti-sorted list W per step, so that a
    step shares one a-tile.

    - ``ti_flat``: (E,) int32 or int64, sorted (equal values adjacent).
    - ``valid``: (E,) bool.
    - ``payloads``: 1 to 32 (E,) int32 or int64 tensors, any stride,
      each taken as int32 (``.int()``, wrap-around); ``pads``: an int
      each.
    - ``W``: entries a step; ``S_cap``: steps.

    Entry i starts a segment when its ti differs from entry i-1's (entry
    0's from -1), valid or not; ``posr`` counts the valid entries of its
    segment before it, a valid entry with ``posr % W == 0`` leads a step,
    and ``gid`` is the number of leaders up to and including it, less 1.
    Returns ``(a_idx, grouped, nsteps)``: (S_cap,) int32, step ``gid``'s
    leader's ti, 0 elsewhere; per payload an (S_cap*W,) int32 list holding
    each valid entry's value at ``gid*W + posr % W``, its pad elsewhere
    (steps at or past ``S_cap`` dropped); and the 0-dim int32 leader count,
    uncapped, so that ``nsteps > S_cap`` tells of an overflow.

    Replaces no TPU kernel: the JAX package's grouping is XLA glue
    (``jax.lax.cummax``, ``implicitbvh_tpu/traverse/tiles.py:346-360``).
    On the H100 it is bound by bytes: ``csrc/leader_group.cu`` (L1) reads
    ti, the flags and the payloads and writes the outputs in two launches
    on the current stream (a tile carry pass that also fills the pads, then
    a scan pass), with no host sync, one allocation and int64 or strided
    payloads read in place.
    """
    payloads, pads = tuple(payloads), tuple(pads)
    E = _check_group(ti_flat, valid, payloads, pads, W, S_cap)
    if not _build.cuda_device(ti_flat):
        return leader_group_plain(ti_flat, valid, payloads, pads, W, S_cap)
    P, I = _build.P, _build.I
    fn = _build.kernel_fn("leader_group", "leader_group_launch",
                          [P, I, P, P, P, P, P] + [I] * 4 + [P, P, P])
    k = len(payloads)
    rows = (ctypes.c_void_p * k)(*(p.data_ptr() for p in payloads))
    strides = (ctypes.c_longlong * k)(*(p.stride(0) for p in payloads))
    wide = (ctypes.c_int * k)(*(p.dtype == torch.int64 for p in payloads))
    pad_arr = (ctypes.c_int * k)(*(int(p) for p in pads))
    SW = S_cap * W
    n_scratch = 4 * -(-E // _TILE)
    # the tiles' carries (16-byte aligned at the start), then a_idx, the k
    # grouped lists and nsteps
    buf = torch.empty(n_scratch + S_cap + k * SW + 1, dtype=torch.int32,
                      device=ti_flat.device)
    out = buf[n_scratch:]
    with torch.cuda.device(ti_flat.device):
        _build.launch(fn, "leader_group", ti_flat.data_ptr(),
                      ti_flat.element_size(), valid.data_ptr(), rows,
                      strides, wide, pad_arr, k, E, W, S_cap,
                      out.data_ptr(), buf.data_ptr())
    tracing.count("launches.leader_group")
    grouped = tuple(out[S_cap + q * SW:S_cap + (q + 1) * SW]
                    for q in range(k))
    return out[:S_cap], grouped, out[S_cap + k * SW]
