"""Answer kind ``rays``: the hit set of a bundle of rays ``p``, ``d`` (each
``(3, n_rays)``) on one set of leaves, as 1-based rows ``(leaf, ray)`` and
int64 keys ``leaf * n_rays + ray``, 0-based."""

from __future__ import annotations

import torch

from .contacts import leaves, n_leaves, ray_hit_keys


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The sorted keys of every forward ray that meets a leaf's sphere, in
    ``dtype``."""
    return ray_hit_keys(*leaves(inputs, dtype), inputs["p"], inputs["d"])


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the keys of 1-based rows and the number of rows
    that name no (leaf, ray) pair."""
    rows = rows.long()
    n = n_leaves(inputs)
    i, j = rows[:, 0] - 1, rows[:, 1] - 1
    n_rays = inputs["p"].shape[1]
    ok = (i >= 0) & (i < n) & (j >= 0) & (j < n_rays)
    keys = i * n_rays + j
    return keys[ok], int((~ok).sum())


def rows_of(keys: torch.Tensor, inputs: dict) -> torch.Tensor:
    """1-based rows of ``keys`` (the inverse of ``keys_of``)."""
    n_rays = inputs["p"].shape[1]
    return torch.stack([keys // n_rays + 1, keys % n_rays + 1], 1)
