"""A captured two-body contact step: a body at rest, built once at set-up,
against a rigid body that is moved, turned into spheres and rebuilt every
step, through ``traverse_tiles_pair_fixed`` on the tile engine's two-tree
route, captured in one CUDA graph as ``self_graph.py`` captures its step.

The configuration's ``scene`` is ``mesh in particles``.  Body 1, ``bed``,
is ``particles`` spheres as ``scene.particles`` draws them (``spacing``,
``radius``); body 2, ``tool``, a closed surface of ``triangles`` faces
with edges about ``edge`` long (``scene.surface``).  Each is drawn from a
generator of its own seeded with ``scene_seed``, so the bed is the
``particles`` scene and the tool the ``closed surface`` scene of the same
sizes, bit for bit; the run's seed draws each body's leaf order.  The
tool's vertex centroid starts at the bed's centre and swings along x by
``traffic["move"]``'s ``amplitude`` times the bed's side, over ``period``
steps.

Set-up builds the bed's BVH, warms the step up, captures it and replays
it for at least ``traffic["settle_s"]`` seconds.  A step moves the tool,
takes its triangles' bounding spheres (``bsphere_from_triangles``),
builds its BVH (``build`` with the configuration's node type) and calls
``traverse_tiles_pair_fixed(bed, tool, capacity,
alg=TileTraversal(**tile), pair_capacity=...)``; it ends in one float64
tensor of the count, the overflow flag and the leaf tests, which the
caller reads each step.  The answer is tree-order rows (bed
particle, tool triangle), 1-based: answer kind ``two_body``.

A traced run captures the step inside ``tracing.enabled()``, with timing
events at its start, after the build and at its end.  After each replay
it reads the build's and the query's device times, and those of the
program's spans captured into the graph (their events are external record
nodes, which every replay records again), summed by span name, into
``layer_ms``.  A run with ``--trace 0`` captures with tracing off.  On the
CPU (the tests) the same calls run eagerly, in a traced run each step
inside ``tracing.enabled()``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import scene
from ..spans import _tracing
from .self_graph import half_spheres


class Step:
    layers = ("build", "traverse")
    # the configurations it runs (``harness.check_config``)
    runs = {"scene": ("mesh in particles",), "leaf": ("BSphere",),
            "node": ("BBox",), "dtype": ("float32",)}

    # for the benchmark's own tests (see ``self_graph.Step``)
    @staticmethod
    def small(config: dict, traffic: dict, leaves: int):
        """Cut both bodies to at most ``leaves`` leaves, and the capacities
        with them (in place)."""
        bed, tool = config["bed"], config["tool"]
        bed["particles"] = min(bed["particles"], leaves)
        tool["triangles"] = min(tool["triangles"], leaves) // 2 * 2
        config["capacity"] = 1024 * -(-16 * leaves // 1024)
        config["pair_capacity"] = 8192

    @staticmethod
    def answer_call(config: dict, traffic: dict) -> str:
        return "traverse_tiles_pair_fixed"

    @staticmethod
    def half_batch(config: dict, traffic: dict):
        return "bsphere_from_triangles", half_spheres

    def __init__(self, config, traffic, seed, device, trace):
        self.config, self.traffic, self.trace = config, traffic, trace
        self.device = dev = torch.device(device)
        bed, tool = config["bed"], config["tool"]
        g = scene.generator(seed, dev)
        self.bed = scene.particles(
            bed["particles"], scene.generator(config["scene_seed"], dev),
            dev, spacing=bed["spacing"], radius=bed["radius"]).shuffled(g)
        self.tool = scene.surface(
            tool["triangles"], scene.generator(config["scene_seed"], dev),
            dev, edge=tool["edge"]).shuffled(g)
        side = bed["spacing"] * float(bed["particles"]) ** (1.0 / 3.0)
        pts = self.tool.points
        self.rest = pts - pts.mean(1, keepdim=True) + 0.5 * side
        # one phase and one direction, +x, for every vertex: a rigid move
        self.phase = torch.zeros((1,), device=dev)
        self.direction = torch.tensor([[1.0], [0.0], [0.0]], device=dev)
        self.swing = traffic["move"]["amplitude"] * side
        self.t = torch.zeros((), dtype=torch.float32, device=dev)
        self.kept, self.times, self.span_ms = {}, [], {}
        self.span_ids, self.reading = set(), True
        self.tracing = _tracing() if trace else None
        # events recorded inside the graph (external record nodes)
        self.marks = [torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(3)] \
            if trace and dev.type == "cuda" else None

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """The tool's triangles at step ``t`` (a 0-dim float32 tensor on the
        device): ``(3 vertices, 3 coordinates, n)``."""
        move = self.traffic["move"]
        return self.tool.leaves(scene.moved(
            self.rest, self.phase, self.direction, t, self.swing,
            move["period"]))["tris"]

    def _step(self):
        """The captured step: move, spheres, build, then the query, timed
        inside the graph in a traced run."""
        ibt, cfg, m = self.ibt, self.config, self.marks
        if m:
            m[0].record()
        tr = self.at(self.t)
        tool = ibt.build(ibt.bsphere_from_triangles(
            tuple(tr[0]), tuple(tr[1]), tuple(tr[2])),
            getattr(ibt, cfg["node"]))
        if m:
            m[1].record()
        total, rows, overflow, checks = ibt.traverse_tiles_pair_fixed(
            self.bed_bvh, tool, cfg["capacity"],
            alg=ibt.TileTraversal(**cfg["tile"]),
            pair_capacity=cfg["pair_capacity"])
        stat = torch.stack([total.double(), overflow.double(),
                            checks.double()])
        if m:
            m[2].record()
        self.t.add_(1.0)
        return stat, rows

    def _traced(self):
        """Record the program's spans inside this block in a traced run."""
        return self.tracing.enabled() if self.tracing is not None \
            else contextlib.nullcontext()

    def _span_ids(self) -> set:
        if self.tracing is None:
            return set()
        return {s["id"] for s in self.tracing.snapshot()["spans"]}

    def _read_spans(self):
        """Append the device ms of the spans of ``span_ids``, summed by
        name, to ``span_ms``.  Left out: a name with a span not yet timed,
        and the program's ``build`` and ``traverse`` spans, whose names
        are the layers' timed by the step's own events."""
        by_name = {}
        for s in self.tracing.snapshot()["spans"]:
            if s["id"] in self.span_ids and s["name"] not in self.layers:
                by_name.setdefault(s["name"], []).append(s["device_ms"])
        for name, ms in by_name.items():
            if None not in ms:
                self.span_ms.setdefault(name, []).append(sum(ms))

    def _eager(self):
        """One step run eagerly (the CPU), its spans read in a traced
        run."""
        before = self._span_ids()
        with self._traced():
            self.stat, self.rows = self._step()
        self.span_ids = self._span_ids() - before

    def setup(self):
        import implicitbvh_tpu_torch as ibt
        self.ibt = ibt
        self.bed_bvh = ibt.build(
            ibt.BSphere(tuple(self.bed.points), self.bed.radii),
            getattr(ibt, self.config["node"]))
        if self.device.type != "cuda":
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm up: loads every kernel
            for _ in range(self.traffic["warmup"]):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = self._span_ids()
        self.graph = torch.cuda.CUDAGraph()
        with self._traced(), torch.cuda.graph(self.graph):
            self.stat, self.rows = self._step()
        self.span_ids = self._span_ids() - before
        # the replays warm too, for at least ``settle_s`` seconds: a fresh
        # process's first seconds of replays run about 7% slower, and stop
        # at a moment that differs from process to process (PERF.md §2)
        i, end = 0, time.perf_counter() + self.traffic["settle_s"]
        while i < self.traffic["warmup"] or time.perf_counter() < end:
            self.run(i)
            i += 1
        self.times.clear()
        self.span_ms.clear()
        self.t.zero_()
        torch.cuda.synchronize()

    def run(self, i: int):
        if self.device.type != "cuda":
            self._eager()
        else:
            self.graph.replay()
        v = self.stat.tolist()
        if self.marks:
            m = self.marks
            self.times.append((m[0].elapsed_time(m[1]),
                               m[1].elapsed_time(m[2])))
        if self.reading and self.span_ids:
            self._read_spans()
        self.last = v
        return int(v[0]), int(v[1]), v[2]

    def keep(self, i: int):
        total = int(self.last[0])
        self.kept[i] = (total,
                        self.rows[:max(0, min(total, self.rows.shape[0]))]
                        .clone())

    def answer(self, i: int):
        return self.kept[i]

    def inputs(self, i: int) -> dict:
        """What the reference takes for step ``i``: the bed's particles and
        the moved tool's triangles."""
        t = torch.tensor(float(i), dtype=torch.float32, device=self.device)
        return {"kind": "two_body", "x1": self.bed.points,
                "r1": self.bed.radii, "tris2": self.at(t)}

    def layer_ms(self) -> dict:
        """The layers' and the spans' device ms of each step so far.  The
        harness takes them before its profiled stretch; reading the spans
        stops here, so the profiled steps' host time holds no reading."""
        out = {name: [t[k] for t in self.times]
               for k, name in enumerate(self.layers)} if self.times else {}
        self.reading = False
        return {**out, **self.span_ms}

    def release(self):
        for name in ("graph", "stat", "rows", "bed_bvh"):
            self.__dict__.pop(name, None)
