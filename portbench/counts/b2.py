"""B2, the count kernel (``ops/tile_contact.py:tile_run_counts`` ->
``csrc/run_counts.cu``, device kernel ``run_counts_kernel``): its bytes and
operations for one call, from the call's own arguments."""

from __future__ import annotations

import torch

from . import peaks

KERNEL = "run_counts_kernel"


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def live_rows(run_idx, bm_words, nsteps, S_cap, Tb, R, NB) -> int:
    """Word rows the kernel writes with ``moments``: the (step, slot, tile)
    pairs of a live step, a non-zero band nibble and a b-tile below
    ``Tb``."""
    SW = run_idx.shape[0]
    W = SW // S_cap
    TPW = 32 // NB
    t = torch.arange(R, device=run_idx.device)
    bmt = (bm_words[t // TPW].T >> (NB * (t % TPW))) & ((1 << NB) - 1)
    tj = (run_idx & 0xFFFF)[:, None] * R + t
    step = torch.arange(SW, device=run_idx.device) // W
    live = (bmt != 0) & (tj < Tb) & \
        (step < nsteps.clamp(max=S_cap))[:, None]
    return int(live.sum())


def bound(args, kw) -> tuple:
    """``peaks.bound_ms`` of one call ``tile_run_counts(*args, **kw)``.

    Operations: every band bit of a live step's slot stands for ``G / NB``
    rows of ``G`` leaf tests (the tile path's ``num_checks``; on a diagonal
    tile pair under ``dedup`` the kernel tests about half of that band, so
    the count is an upper bound there), times the test's float operations.
    Bytes: each input read once (one field set counted once when both
    sides are the same tensor), the two (S_cap * W * R,) int32 outputs
    written once, and with ``moments`` 128 int32 words for each live pair's
    row."""
    a_idx, run_idx, bm, nsteps, *fields = args
    G = fields[0].shape[2]
    NB, R = kw.get("NB", 4), kw.get("R", 8)
    W = run_idx.shape[0] // a_idx.shape[0]
    step_live = (torch.arange(run_idx.shape[0], device=run_idx.device)
                 // W) < nsteps.clamp(max=a_idx.shape[0])
    tests = int((popcount(bm) * step_live).sum()) * (G // NB) * G
    rows_out = run_idx.shape[0] * R
    rows_live = live_rows(run_idx, bm, nsteps, a_idx.shape[0],
                          fields[-1].shape[1], R, NB) \
        if kw.get("moments") else 0
    unique = {t.data_ptr(): t for t in fields}.values()
    nbytes = _nbytes((a_idx, run_idx, bm, nsteps, *unique)) + \
        2 * rows_out * 4 + rows_live * 128 * 4
    return peaks.bound_ms(nbytes, tests * peaks.FLOPS_PER_TEST[
        kw["mask_kind"]], fields[0].dtype)
