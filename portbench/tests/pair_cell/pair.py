"""Answer kind ``pair``: the contact set of two bodies of particles, ``x1``,
``r1`` against ``x2``, ``r2``, as 1-based rows ``(i1, i2)`` in each body's
own order and int64 keys ``i1 * n2 + i2``, 0-based.  The reference is a
brute force over every (body 1, body 2) pair with the test of
``contacts.self_contact_keys``, ``|x_1 - x_2|^2 <= (r_1 + r_2)^2`` in
``dtype``."""

from __future__ import annotations

import torch


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The sorted keys of every pair of touching spheres, one of each
    body."""
    x1, r1 = inputs["x1"].to(dtype), inputs["r1"].to(dtype)
    x2, r2 = inputs["x2"].to(dtype), inputs["r2"].to(dtype)
    d = [x1[k][:, None] - x2[k][None, :] for k in range(3)]
    rr = r1[:, None] + r2[None, :]
    hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
    i1, i2 = hit.nonzero(as_tuple=True)
    return torch.sort(i1 * r2.shape[0] + i2).values


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the keys of 1-based rows and the number of rows
    that name no (body 1, body 2) pair."""
    rows = rows.long()
    n1, n2 = inputs["r1"].shape[0], inputs["r2"].shape[0]
    i, j = rows[:, 0] - 1, rows[:, 1] - 1
    ok = (i >= 0) & (i < n1) & (j >= 0) & (j < n2)
    keys = i * n2 + j
    return keys[ok], int((~ok).sum())


def rows_of(keys: torch.Tensor, inputs: dict) -> torch.Tensor:
    """1-based rows of ``keys`` (the inverse of ``keys_of``)."""
    n2 = inputs["r2"].shape[0]
    return torch.stack([keys // n2 + 1, keys % n2 + 1], 1)
