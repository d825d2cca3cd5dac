"""Answer kind ``self``: the contact set of one set of leaves (the
triangles' spheres, or the particles), as 1-based rows ``(i, j)`` with
``i < j`` and int64 keys ``i * n + j``, 0-based."""

from __future__ import annotations

import torch

from .contacts import leaves, n_leaves, self_contact_keys


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The sorted keys of every pair of leaves that touch, in ``dtype``."""
    return self_contact_keys(*leaves(inputs, dtype))


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the keys of 1-based rows and the number of rows
    that name no pair ``i < j`` of the leaves."""
    rows = rows.long()
    n = n_leaves(inputs)
    i, j = rows[:, 0] - 1, rows[:, 1] - 1
    ok = (i >= 0) & (i < j) & (j < n)
    keys = i * n + j
    return keys[ok], int((~ok).sum())


def rows_of(keys: torch.Tensor, inputs: dict) -> torch.Tensor:
    """1-based rows of ``keys`` (the inverse of ``keys_of``)."""
    n = n_leaves(inputs)
    return torch.stack([keys // n + 1, keys % n + 1], 1)
