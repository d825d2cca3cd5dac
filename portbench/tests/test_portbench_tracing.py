"""The readers of the program's spans and counters (``spans.py`` and the
metrics that use it) on a small traced cell on the CPU, on a timeline made
by hand, and against a program without spans."""

import sys

import pytest

import implicitbvh_tpu_torch as ibt
from implicitbvh_tpu_torch import tracing
from portbench import harness, spans
from portbench.tests.cell_checks import run
from portbench.tests.small import small_cell

SPAN_METRICS = ("traverse_span_ms", "phase1_ms", "program_idle_ms")
COUNTER_METRICS = ("syncs_per_step", "tile_runs_per_step",
                   "walk_fallback_pct")


def test_the_readers_on_a_small_traced_cell():
    tracing.reset()
    cell = small_cell("dragon-rays")
    res, compared = run(cell, trace=True)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    listed = {x["name"] for x in cell.per_layer}
    # the CPU has no device timeline: the idle reader reads nothing
    assert "program_idle_ms" in listed and "program_idle_ms" not in m
    want = listed & set(SPAN_METRICS + COUNTER_METRICS) - \
        {"program_idle_ms"}
    assert want <= set(m)
    # three reads a run that ends the call, one a run that overflows
    assert m["tile_runs_per_step"] >= 1.0
    assert m["syncs_per_step"] == pytest.approx(
        2.0 + m["tile_runs_per_step"])
    assert 0 < m["phase1_ms"] < m["traverse_span_ms"]
    assert m["walk_fallback_pct"] == 0.0
    # the window before the profiled stretch, on the host's clock
    assert res["attempted"] > 8
    assert 0 < m["step_wall_ms"] and 0 < m["step_wall_p95_ms"]


def timeline(monkeypatch, spans_made):
    """A trace of one step, 0-100 ns, with device work at 10-20 and
    60-80 ns, and the program's spans ``spans_made``."""
    tr = harness.Trace(steps=1, window_ns=(0, 100),
                       device_ops=[("k", 10, 10), ("k", 60, 20)])
    snap = {"spans": spans_made, "counters": {}, "dropped": 0}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return tr


def made(name, start, end, parent=None, device_ms=1.0):
    return {"name": name, "id": start, "parent": parent, "call": 1,
            "start_ns": start, "end_ns": end, "host_ms": (end - start) / 1e6,
            "device_ms": device_ms, "captured": False, "attrs": {}}


def test_idle_inside_spans_by_hand(monkeypatch):
    tr = timeline(monkeypatch, [made("traverse", 5, 70),
                                made("tiles.phase1", 30, 50, parent=5),
                                made("traverse", 90, 120)])  # past it
    # gaps 0-10, 20-60, 80-100; inside 5-70: 5 + 40 ns
    assert harness.metric_reader("program_idle_ms")(tr) == 45 / 1e6
    assert harness.metric_reader("traverse_span_ms")(tr) == 1.0
    assert harness.metric_reader("phase1_ms")(tr) == 1.0


def test_a_span_not_yet_timed_reads_nothing(monkeypatch):
    tr = timeline(monkeypatch, [made("traverse", 5, 70, device_ms=None)])
    assert harness.metric_reader("traverse_span_ms")(tr) is None


def test_intervals():
    assert spans.union([(5, 9), (1, 3), (2, 4), (9, 10)]) == [[1, 4],
                                                             [5, 10]]
    assert spans.overlap_ns([[0, 10], [20, 30]], [[5, 25]]) == 10
    assert spans.overlap_ns([], [[0, 1]]) == 0


def test_the_counter_readers_are_ratios_over_the_calls(monkeypatch):
    tracing.reset()
    tr = harness.Trace(steps=1)
    for m in COUNTER_METRICS:
        assert harness.metric_reader(m)(tr) is None   # no call yet
    tracing.count("calls.traverse", 4)
    tracing.count("grow.runs", 6)
    tracing.count("grow.walks", 1)
    tracing.count("syncs.tiles.overflow", 6)
    tracing.count("syncs.tiles.total", 3)
    assert harness.metric_reader("tile_runs_per_step")(tr) == 1.5
    assert harness.metric_reader("walk_fallback_pct")(tr) == 25.0
    assert harness.metric_reader("syncs_per_step")(tr) == 9 / 4
    tracing.reset()


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The readers on a program that has no ``tracing`` module (as before
    it had one) return None and raise nothing."""
    tracing.count("calls.traverse")
    monkeypatch.delattr(ibt, "tracing")
    monkeypatch.setitem(sys.modules, "implicitbvh_tpu_torch.tracing", None)
    tr = harness.Trace(steps=1, window_ns=(0, 100),
                       device_ops=[("k", 10, 10)])
    for m in SPAN_METRICS + COUNTER_METRICS:
        assert harness.metric_reader(m)(tr) is None, m


def test_the_window_readers_by_hand():
    tr = harness.Trace(window_steps=4, window_s=0.02,
                       latencies=[0.004, 0.005, 0.005, 0.006])
    assert harness.metric_reader("step_wall_ms")(tr) == pytest.approx(5.0)
    assert harness.metric_reader("step_wall_p95_ms")(tr) == pytest.approx(
        1e3 * harness.percentile(tr.latencies, 95))
    for m in ("step_wall_ms", "step_wall_p95_ms"):
        assert harness.metric_reader(m)(harness.Trace()) is None


class Event:
    def __init__(self, on_device, start, duration):
        from torch.autograd import DeviceType
        self.kind = DeviceType.CUDA if on_device else DeviceType.CPU
        self.start, self.duration = start, duration

    def device_type(self):
        return self.kind

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.duration


def test_the_window_busy_time_counts_device_operations_inside_it():
    """``step_device_ms``'s reading: the union of the device operations'
    intervals inside the window; host records and time outside it do not
    count."""
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Event(True, 0, 20),      # 10-20 inside
                            Event(True, 30, 10),     # 30-40
                            Event(True, 35, 15),     # overlaps: 40-50
                            Event(False, 50, 40),    # a host record
                            Event(True, 95, 20)]     # 95-100 inside
    assert harness.device_busy_ns(Prof, (10, 100)) == 10 + 20 + 5
