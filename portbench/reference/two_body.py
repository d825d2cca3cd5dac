"""Answer kind ``two_body``: the contact set of two bodies, each a set of
particles (``x1``, ``r1``) or of triangles (``tris1``), and so for body 2,
as 1-based rows ``(i1, i2)`` in each body's own order and int64 keys ``i1
* n2 + i2``, 0-based.

The reference takes the triangles' spheres from ``contacts.spheres`` and
lists the cross pairs of ``contacts.self_contact_keys`` over both bodies'
spheres together: the blocked grid, whose test ``|x_a - x_b|^2 <= (r_a +
r_b)^2`` gives the same bits whichever of the two spheres comes first."""

from __future__ import annotations

import torch

from .contacts import self_contact_keys, spheres


def body(inputs: dict, k: int, dtype=torch.float32):
    """``(centres (3, n), radii (n,))`` of body ``k`` (1 or 2) in
    ``dtype``: the spheres of its triangles, or its particles."""
    if f"tris{k}" in inputs:
        return spheres(inputs[f"tris{k}"], dtype)
    return inputs[f"x{k}"].to(dtype), inputs[f"r{k}"].to(dtype)


def sizes(inputs: dict) -> tuple:
    """``(n1, n2)``: the leaves of each body."""
    return tuple(inputs[f"tris{k}"].shape[2] if f"tris{k}" in inputs
                 else inputs[f"r{k}"].shape[0] for k in (1, 2))


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The sorted keys of every pair of touching spheres, one of each body,
    in ``dtype``."""
    (x1, r1), (x2, r2) = body(inputs, 1, dtype), body(inputs, 2, dtype)
    n1, n2 = r1.shape[0], r2.shape[0]
    n = n1 + n2
    keys = self_contact_keys(torch.cat([x1, x2], 1), torch.cat([r1, r2]))
    i, j = keys // n, keys % n          # i < j: body 1 comes first
    cross = (i < n1) & (j >= n1)
    return torch.sort(i[cross] * n2 + (j[cross] - n1)).values


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the keys of 1-based rows and the number of rows
    that name no (body 1, body 2) pair."""
    rows = rows.long()
    n1, n2 = sizes(inputs)
    i, j = rows[:, 0] - 1, rows[:, 1] - 1
    ok = (i >= 0) & (i < n1) & (j >= 0) & (j < n2)
    keys = i * n2 + j
    return keys[ok], int((~ok).sum())


def rows_of(keys: torch.Tensor, inputs: dict) -> torch.Tensor:
    """1-based rows of ``keys`` (the inverse of ``keys_of``)."""
    n2 = sizes(inputs)[1]
    return torch.stack([keys // n2 + 1, keys % n2 + 1], 1)
