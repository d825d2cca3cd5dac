"""The comparison that decides ``correct``: the set a step of the window
returned against the plain reference's set for that step's inputs.

The number compared is ``pairs_off``: rows that name no valid pair, rows
repeated, pairs the step listed that the reference lacks, pairs of the
reference the step did not list, and the gap between the step's count and
the reference's.  The spheres and tests are float32 on both sides, so a
sound step gives 0, and the limit is 0.
"""

from __future__ import annotations

import torch

from .reference import contacts as ref

LIMITS = {"pairs_off": 0}


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The reference's sorted keys for one step's inputs (see
    ``steps``; the spheres of its triangles, or its particles, in
    ``dtype``): self-contact keys ``i * n + j`` or ray keys ``leaf * n_rays
    + ray``, 0-based."""
    if "tris" in inputs:
        x, r = ref.spheres(inputs["tris"], dtype)
    else:
        x, r = inputs["x"].to(dtype), inputs["r"].to(dtype)
    if inputs["kind"] == "self":
        return ref.self_contact_keys(x, r)
    return ref.ray_hit_keys(x, r, inputs["p"], inputs["d"])


def n_leaves(inputs: dict) -> int:
    """The number of leaves (triangles or particles) of one step's
    inputs."""
    return inputs["tris"].shape[2] if "tris" in inputs else \
        inputs["r"].shape[0]


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the int64 keys of 1-based rows (self: sorted
    ``(i, j)`` with ``i < j``; rays: ``(leaf, ray)``) and the number of rows
    that name no such pair."""
    rows = rows.long()
    n = n_leaves(inputs)
    i, j = rows[:, 0] - 1, rows[:, 1] - 1
    if inputs["kind"] == "self":
        ok = (i >= 0) & (i < j) & (j < n)
        keys = i * n + j
    else:
        n_rays = inputs["p"].shape[1]
        ok = (i >= 0) & (i < n) & (j >= 0) & (j < n_rays)
        keys = i * n_rays + j
    return keys[ok], int((~ok).sum())


def pairs_off(total: int, rows: torch.Tensor, inputs: dict,
              want: torch.Tensor) -> int:
    """How far a step's answer (``total`` and its listed ``rows``) is from
    the reference's sorted keys ``want``."""
    keys, invalid = keys_of(rows, inputs)
    uniq = torch.unique(keys)
    want = want.to(uniq.device)
    repeated = keys.shape[0] - uniq.shape[0]
    extra = int((~torch.isin(uniq, want)).sum())
    missing = int((~torch.isin(want, uniq)).sum())
    return invalid + repeated + extra + missing + abs(int(total) -
                                                      want.shape[0])
