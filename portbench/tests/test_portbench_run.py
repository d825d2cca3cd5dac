"""A run end to end on the CPU at a small size: the reference's set
equals the program's, the result line has the contract's keys, the command
refuses to run without a card, the control and every fault the cells can
have come out not correct."""

import json
import subprocess
import sys
import time

import pytest
import torch

import implicitbvh_tpu_torch as ibt
from portbench import control, harness
from portbench.tests.small import cells, small_cell

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run(cell, trace=False, seed=2 ** 31 + 11, **kw):
    kw.setdefault("check_at", [3])
    kw.setdefault("min_steps", 8)
    return harness.run_cell(cell, seed, 0.05, trace, "cpu", time.time(),
                            **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", cells())
def test_reference_equals_the_program_on_the_cpu(name, trace):
    cell = small_cell(name)
    res, compared = run(cell, trace)
    assert res["correct"] and compared == {"pairs_off": (0, 0)}
    assert res["attempted"] >= 8 and res["failed"] == 0
    line = json.loads(harness.result_line(res, compared))
    assert RESULT_KEYS <= set(line) and list(line)[-1] == "compared"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


# the faults a cell can have, planted in the program's calls the step
# drivers make
QUERY = {"particles1m-step-graph": "traverse_tiles_fixed",
         "dragon-lvt-graph": "traverse_lvt_single_fixed",
         "dragon-rays": "traverse_rays"}


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


def half_spheres(fn):
    """Half of the batch left out: spheres of the first half of the
    triangles only."""
    def call(p1, p2, p3, *args, **kw):
        h = p1[0].shape[0] // 2
        return fn(*(tuple(c[:h] for c in p) for p in (p1, p2, p3)),
                  *args, **kw)
    return call


def half_particles(fn):
    """Half of the batch left out: the first half of the particles
    only."""
    def call(xs, r, *args, **kw):
        h = r.shape[0] // 2
        return fn(tuple(c[:h] for c in xs), r[:h], *args, **kw)
    return call


def half_rays(fn):
    """Half of the batch left out: the first half of the rays only."""
    def call(bvh, p, d, *args, **kw):
        h = p.shape[1] // 2
        return fn(bvh, p[:, :h], d[:, :h], *args, **kw)
    return call


HALF = {"dragon-rays": ("traverse_rays", half_rays),
        "dragon-lvt-graph": ("bsphere_from_triangles", half_spheres),
        "particles1m-step-graph": ("BSphere", half_particles)}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", cells())
def test_each_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    cell.traffic.get("move", {})["period"] = 16
    target = QUERY[name]
    if fault == "half":
        target, wrap = HALF[name]
    else:
        wrap = stale if fault == "stale" else altered
    monkeypatch.setattr(ibt, target, wrap(getattr(ibt, target)))
    res, compared = run(cell)
    assert not res["correct"] and compared["pairs_off"][0] > 0


@pytest.mark.parametrize("name", cells())
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place passes the limit
    on every step it checks, on three seeds."""
    cell = small_cell(name)
    for seed in (1, 2, 3):
        for _, off, limit in control.control(cell, seed, torch.bfloat16,
                                             "cpu"):
            assert off > limit
