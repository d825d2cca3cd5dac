"""The comparison that decides ``correct``: the set a step of the window
returned against the plain reference's set for that step's inputs.

What a step's answer is depends on its query: ``inputs["kind"]`` names an
answer kind, the module ``reference/<kind>.py`` of the benchmark's folder,
which gives the reference's keys, the keys of the step's rows and the rows
of keys (see ``kind``).

The number compared is ``pairs_off``: rows that name no valid pair, rows
repeated, pairs the step listed that the reference lacks, pairs of the
reference the step did not list, and the gap between the step's count and
the reference's.  The leaves and tests are in the configuration's
precision on both sides, so a sound step gives 0, and the limit is 0.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from .reference.contacts import n_leaves  # noqa: F401 (a public name)

HERE = Path(__file__).resolve().parent
LIMITS = {"pairs_off": 0}
# what an answer kind's module gives
KIND = ("reference_keys", "keys_of", "rows_of")
_KINDS = {}         # path -> the loaded module


def kind(name, here: Path = HERE):
    """The answer kind ``name``: the module ``reference/<name>.py`` under
    ``here``, the benchmark's folder, loaded once, with

    - ``reference_keys(inputs, dtype)``: the plain reference's sorted int64
      keys, computed in ``dtype``;
    - ``keys_of(rows, inputs)``: ``(keys, invalid)``, the keys of 1-based
      rows and the number of rows that name no valid pair;
    - ``rows_of(keys, inputs)``: 1-based rows of keys, the inverse of
      ``keys_of``.

    It may import the reference's modules relatively (``from .contacts
    import ...``); it is not entered in ``sys.modules``.  Raises
    ``ValueError`` naming a kind that has no such module."""
    path = Path(here) / "reference" / f"{name}.py"
    if not (isinstance(name, str) and name.isidentifier()
            and path.is_file()):
        raise ValueError(f"no answer kind {name!r}: the benchmark has no "
                         f"module reference/{name}.py")
    module = _KINDS.get(path)
    if module is None:
        spec = importlib.util.spec_from_file_location(
            f"portbench.reference.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _KINDS[path] = module
    lacks = [f for f in KIND if not callable(getattr(module, f, None))]
    if lacks:
        raise ValueError(f"reference/{name}.py is no answer kind {name!r}: "
                         f"it lacks {', '.join(lacks)}")
    return module


def reference_keys(inputs: dict, dtype=torch.float32) -> torch.Tensor:
    """The reference's sorted keys for one step's inputs (see ``steps``),
    computed in ``dtype`` by the inputs' answer kind."""
    return kind(inputs["kind"]).reference_keys(inputs, dtype)


def keys_of(rows: torch.Tensor, inputs: dict):
    """``(keys, invalid)``: the int64 keys of 1-based rows and the number
    of rows that name no pair of the inputs' answer kind."""
    return kind(inputs["kind"]).keys_of(rows, inputs)


def keys_off(total: int, keys: torch.Tensor, invalid: int,
             want: torch.Tensor) -> int:
    """How far an answer is from the reference's sorted keys ``want``:
    ``total``, its count; ``keys`` and ``invalid``, its rows' keys and the
    number of its rows that name no pair (``keys_of``)."""
    uniq = torch.unique(keys)
    want = want.to(uniq.device)
    repeated = keys.shape[0] - uniq.shape[0]
    extra = int((~torch.isin(uniq, want)).sum())
    missing = int((~torch.isin(want, uniq)).sum())
    return invalid + repeated + extra + missing + abs(int(total) -
                                                      want.shape[0])


def pairs_off(total: int, rows: torch.Tensor, inputs: dict,
              want: torch.Tensor) -> int:
    """How far a step's answer (``total`` and its listed ``rows``) is from
    the reference's sorted keys ``want``."""
    return keys_off(total, *keys_of(rows, inputs), want)
