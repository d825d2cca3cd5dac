"""Answer kinds (``reference/<kind>.py``, found by ``check.kind``): the
cells' kinds give the keys, the rows and the control's figures that the
comparison gave before kinds were modules, and a kind with no module is
refused, never checked as another."""

import hashlib
import re
import sys

import pytest
import torch

from portbench import check, control, harness
from portbench.tests.small import small_cell

# on the small cells, seed 7: (step, the reference's count, the first 16
# hex digits of the sha256 of its keys' bytes); the control's (step,
# pairs_off) at seed 1; as the comparison gave them with the kinds written
# inline in check.py and control.py
PINNED = {
    "particles1m-step-graph": ([(0, 78, "6f49c59906ed152d"),
                                (5, 79, "5d1414f95e5712a1")],
                               [(9, 18), (37, 12)]),
    "dragon-rays": ([(0, 931, "f7bc5ef5451f7202"),
                     (5, 868, "692ce8998b6293b4")],
                    [(9, 626)]),
    "dragon-lvt-graph": ([(0, 9868, "1b84b33d038145ef"),
                          (5, 9870, "4175d99fa2f07dd7")],
                         [(9, 704), (37, 680)]),
}


def digest(keys: torch.Tensor) -> str:
    return hashlib.sha256(keys.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_kinds_give_the_keys_they_gave_before(name):
    cell = small_cell(name)
    drv = harness.step_driver(cell.traffic)(cell.config, cell.traffic, 7,
                                            torch.device("cpu"), False)
    keys_pinned, control_pinned = PINNED[name]
    for step, count, want in keys_pinned:
        inputs = drv.inputs(step)
        keys = check.reference_keys(inputs)
        assert (keys.shape[0], digest(keys)) == (count, want)
        rows = check.kind(inputs["kind"]).rows_of(keys, inputs)
        assert torch.equal(check.keys_of(rows, inputs)[0], keys)
        assert check.pairs_off(count, rows, inputs, keys) == 0
    assert [(step, off) for step, off, _ in control.control(
        cell, 1, torch.bfloat16, "cpu")] == control_pinned


@pytest.mark.parametrize("name", ["pair", "contacts", "../steps/rays_api",
                                  3])
def test_a_kind_with_no_module_is_refused(name):
    """Inputs that a self or a ray check could read, under a kind with no
    module: every entry of the check refuses them, naming the kind, and
    the reference's own modules stay as they were."""
    loaded = dict(sys.modules)
    inputs = {"kind": name, "x": torch.zeros((3, 2)), "r": torch.ones(2),
              "p": torch.zeros((3, 1)), "d": torch.ones((3, 1))}
    rows = torch.tensor([[1, 2]])
    calls = (lambda: check.reference_keys(inputs),
             lambda: check.keys_of(rows, inputs),
             lambda: check.pairs_off(1, rows, inputs,
                                     torch.zeros(1, dtype=torch.int64)))
    for call in calls:
        with pytest.raises(ValueError, match=re.escape(repr(name))):
            call()
    assert {k: v for k, v in sys.modules.items() if k in loaded} == loaded
