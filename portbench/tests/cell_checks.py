"""What every cell is held to on the CPU, as functions of a cell, so that
a cell added as files (``test_portbench_layout.py``) meets the same: the
reference's set equals the program's and the result line has the
contract's keys; every fault the cell can have, planted where its step
driver says, comes out not correct; the control comes out not
correct."""

import json
import time

import torch

import implicitbvh_tpu_torch as ibt
from portbench import control, harness

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
FAULTS = ("stale", "half", "altered")


def run(cell, trace=False, seed=2 ** 31 + 11, **kw):
    kw.setdefault("check_at", [3])
    kw.setdefault("min_steps", 8)
    return harness.run_cell(cell, seed, 0.05, trace, "cpu", time.time(),
                            **kw)


def check_run(cell, trace: bool):
    """A sound run is correct, with the result line the contract asks."""
    res, compared = run(cell, trace)
    assert res["correct"] and compared == {"pairs_off": (0, 0)}
    assert res["attempted"] >= 8 and res["failed"] == 0
    line = json.loads(harness.result_line(res, compared))
    assert RESULT_KEYS <= set(line) and list(line)[-1] == "compared"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:   # the CPU has no device timeline to read
        assert set(line["metrics"]) == {m["name"] for m in want
                                        if m["source"] != "device_trace"}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def stale(fn):
    """A step that returns its state unchanged: the first answer again."""
    first = []

    def call(*args, **kw):
        if not first:
            first.append(fn(*args, **kw))
        return first[0]
    return call


def altered(fn):
    """One answer altered where it is produced: a row's second index."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        rows = out.cache1 if hasattr(out, "cache1") else out[1]
        rows[0, 1] += 1
        return out
    return call


def check_fault(cell, fault: str, monkeypatch):
    """``fault`` (one of ``FAULTS``), planted in the program's call that
    the cell's step driver names, makes the run not correct."""
    drv = harness.step_driver(cell.traffic, cell.here)
    cell.traffic.get("move", {})["period"] = 16
    if fault == "half":
        target, wrap = drv.half_batch(cell.config, cell.traffic)
    else:
        target = drv.answer_call(cell.config, cell.traffic)
        wrap = stale if fault == "stale" else altered
    monkeypatch.setattr(ibt, target, wrap(getattr(ibt, target)))
    res, compared = run(cell)
    assert not res["correct"] and compared["pairs_off"][0] > 0


def check_control(cell):
    """The reference in bfloat16 in the program's place passes the limit
    on every step it checks, on three seeds."""
    for seed in (1, 2, 3):
        for _, off, limit in control.control(cell, seed, torch.bfloat16,
                                             "cpu"):
            assert off > limit
