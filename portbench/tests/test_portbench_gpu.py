"""The cells on the card at a small size: the captured and eager paths,
the traced run's readers and the check (``-m gpu``; they skip without a
card)."""

import time

import pytest

from portbench import harness
from portbench.tests.small import cells, small_cell


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", cells())
def test_cell_on_the_card(name, trace, cuda):
    cell = small_cell(name, leaves=20_000)
    res, compared = harness.run_cell(cell, 2 ** 33 + 5, 0.5, trace, cuda,
                                     time.time(), check_at=[3], min_steps=8)
    assert res["correct"] and compared["pairs_off"][0] == 0
    assert res["device"]["platform"] == "gpu"
    if not trace:   # every end-to-end metric, the device's timeline's too
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for m in res["metrics"]:
            if m.endswith("_roofline"):
                assert 0 < res["metrics"][m]["value"] <= 100
