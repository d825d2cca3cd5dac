"""``BENCHMARK.json`` against the benchmark's contract, every file it
names loads by name, and a new configuration, traffic mix, cell and
per-layer metric need only new files."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.cell_checks import (FAULTS, check_control, check_fault,
                                         check_run, run)
from portbench.tests.small import small_cell

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[group]}) == len(SPEC[group])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line_ok(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        # every cell that reads it reports the metric it moves
        for w in m.get("workloads", cells):
            assert e2e[m["moves"]] in harness.for_cell(SPEC["end_to_end"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:   # setup_s, another end-to-end metric, a per-layer one
        assert len(harness.for_cell(SPEC["end_to_end"], w)) >= 2
        assert harness.for_cell(SPEC["per_layer"], w)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    conf = {x["name"]: x for x in SPEC["configs"]}[
        {w["name"]: w for w in SPEC["workloads"]}[cell]["config"]]
    assert set(conf["reduced"]) <= set(c.config)
    assert callable(harness.step_driver(c.traffic))
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_needs_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    per-layer metric as files (and entries in ``BENCHMARK.json``), and run
    the new cell: no file that was there is edited."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    conf = json.loads((harness.ROOT / "portbench/configs/particles-1m.json")
                      .read_text())
    conf.update(name="tiny-particles", particles=900, capacity=4096,
                pair_capacity=8192)
    (here / "configs" / "tiny-particles.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "moving-tiles-graph.json")
                         .read_text())
    traffic["move"]["period"] = 32
    (here / "traffic" / "moving-tiles-fast.json").write_text(
        json.dumps(traffic))
    (here / "metrics" / "steps_traced.py").write_text(
        "def read(tr):\n    return float(tr.steps) if tr.steps else None\n")
    spec["configs"].append({"name": "tiny-particles", "source": "a test",
                            "file": "portbench/configs/tiny-particles.json",
                            "reduced": ["particles"], "why": "a test"})
    spec["workloads"].append({"name": "tiny-fast", "config": "tiny-particles",
                              "traffic": "moving-tiles-fast", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "entry", "moves": "step_ms",
                              "workloads": ["tiny-fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny-fast", tmp_path, here)
    cell.traffic["trace"]["profile_steps"] = 2
    res, compared = harness.run_cell(cell, 5, 0.05, True, "cpu",
                                     time.time(), check_at=[1])
    assert res["correct"] and compared["pairs_off"][0] == 0
    assert res["metrics"]["steps_traced"]["value"] == 2.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("key,value", [("dtype", "float64"),
                                       ("leaf", "BBox"),
                                       ("scene", "triangle soup")])
def test_a_configuration_the_drivers_do_not_run_is_refused(tmp_path, key,
                                                           value):
    """A configuration that states a value of ``scene``, ``leaf`` or
    ``dtype`` that the drivers do not run is refused when its cell loads,
    never run as another."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    conf = json.loads((harness.ROOT / "portbench/configs/particles-1m.json")
                      .read_text())
    conf[key] = value
    (tmp_path / "portbench/configs/particles-1m.json").write_text(
        json.dumps(conf))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    cell = [w["name"] for w in SPEC["workloads"]
            if w["config"] == "particles-1m"][0]
    with pytest.raises(ValueError, match=key):
        harness.load_cell(cell, tmp_path)


PAIR_CELL = Path(__file__).resolve().parent / "pair_cell"


def with_the_pair_cell(tmp_path):
    """A copy of the benchmark in ``tmp_path`` with a two-body cell,
    ``tiny-pair``, added as files: the answer kind ``reference/pair.py``,
    the driver ``steps/pair_tiles.py``, a configuration, a traffic mix and
    their entries in ``BENCHMARK.json``.  Returns the copy's folder and the
    bytes of every file it had before."""
    here = tmp_path / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    for name, to in (("pair.py", "reference"), ("pair_tiles.py", "steps"),
                     ("tiny-pair.json", "configs"),
                     ("pair-tiles.json", "traffic")):
        shutil.copyfile(PAIR_CELL / name, here / to / name)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny-pair", "source": "a test",
                            "file": "portbench/configs/tiny-pair.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-pair", "config": "tiny-pair",
                              "traffic": "pair-tiles", "chips": 1,
                              "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return here, before


def test_a_new_query_kind_needs_only_new_files(tmp_path, monkeypatch):
    """A two-tree cell added as files only (its answer kind, its driver,
    its configuration and mix), cut by ``small_cell`` as any cell is, runs
    correct and meets what every cell is held to (``cell_checks``): each
    fault, a row dropped and the control come out not correct; no file
    that was there is edited."""
    import implicitbvh_tpu_torch as ibt
    from portbench import check
    here, before = with_the_pair_cell(tmp_path)
    cell = small_cell("tiny-pair", tmp_path, here)
    drv = harness.step_driver(cell.traffic, here)(
        cell.config, cell.traffic, 2 ** 31 + 11, "cpu", False)
    for i in (1, 3):    # the check is not empty
        inputs = drv.inputs(i)
        assert check.kind(inputs["kind"], here).reference_keys(
            inputs).shape[0] > 0
    for trace in (False, True):
        check_run(cell, trace)
    check_control(cell)
    for fault in FAULTS:
        with monkeypatch.context() as m:
            check_fault(small_cell("tiny-pair", tmp_path, here), fault, m)
    query = ibt.traverse_tiles_pair_fixed

    def dropped(*args, **kw):
        total, rows, overflow, checks = query(*args, **kw)
        return total - 1, rows, overflow, checks
    monkeypatch.setattr(ibt, "traverse_tiles_pair_fixed", dropped)
    res, compared = run(small_cell("tiny-pair", tmp_path, here))
    assert not res["correct"] and compared["pairs_off"][0] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_value_is_checked_against_its_own_driver(tmp_path):
    """A configuration's ``scene`` is checked against the driver its cell's
    traffic names: refused where that driver does not declare it, though
    another driver does."""
    here, _ = with_the_pair_cell(tmp_path)
    harness.load_cell("tiny-pair", tmp_path, here)
    for cell, path, scene in (
            ("particles1m-step-graph", "configs/particles-1m.json",
             "particle pair"),
            ("tiny-pair", "configs/tiny-pair.json", "particles")):
        conf = json.loads((here / path).read_text())
        conf["scene"] = scene
        (here / path).write_text(json.dumps(conf))
        with pytest.raises(ValueError, match="scene"):
            harness.load_cell(cell, tmp_path, here)
