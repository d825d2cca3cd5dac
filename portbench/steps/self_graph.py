"""A captured self-contact step: move -> bounding spheres
(``bsphere_from_triangles`` or the particles' ``BSphere``) -> ``build``
-> a fixed-capacity query, captured in one CUDA graph as
``implicitbvh_tpu_torch/entry.py`` documents and replayed each step.

``traffic["query"]`` names the query: ``tiles_fixed``
(``traverse_tiles_fixed`` with the configuration's ``TileTraversal``,
``capacity`` and ``pair_capacity``) or ``lvt_fixed``
(``traverse_lvt_single_fixed`` at ``capacity``).  The graph ends with the
count, the overflow flag (for the walk: the count past the capacity) and
the tile query's leaf tests in one float64 tensor, which the caller reads
each step.  A traced run captures three timing events into the graph, at
its start, after the build and at its end, and reads the two stretches
after each replay.  On the CPU (the tests) the same calls run eagerly.
"""

from __future__ import annotations

import torch

from .. import scene


class MovingScene:
    """The cell's inputs: the configuration's scene in the order, and with
    the phases and directions, that the run's seed draws, moved by
    ``traffic["move"]`` (``amplitude`` in units of the scene's scale,
    ``period`` in steps).  ``t`` is the step counter on the device, ``t ==
    i`` at the start of step ``i``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.scene, g = scene.configured(config, seed, device)
        self.phase, self.direction = scene.motion(
            self.scene.points.shape[1], g, device)
        self.t = torch.zeros((), dtype=torch.float32, device=device)
        self.kept = {}

    def at(self, t: torch.Tensor) -> dict:
        """The leaves at step ``t`` (see ``scene.Scene.leaves``)."""
        move = self.traffic["move"]
        return self.scene.leaves(scene.moved(
            self.scene.points, self.phase, self.direction, t,
            move["amplitude"] * self.scene.scale, move["period"]))

    def build(self, ibt):
        """The program's build at the current step: leaves -> bounding
        spheres -> BVH with the configuration's node type."""
        return ibt.build(spheres(ibt, self.at(self.t)),
                         getattr(ibt, self.config["node"]))

    def inputs(self, i: int) -> dict:
        """What the reference takes for step ``i``: the moved leaves."""
        t = torch.tensor(float(i), dtype=torch.float32, device=self.device)
        return {"kind": "self", **self.at(t)}

    def keep(self, i: int, total: int, rows: torch.Tensor):
        """Keep step ``i``'s answer: its count and a copy of its first
        ``min(total, capacity)`` rows."""
        self.kept[i] = (int(total),
                        rows[:max(0, min(int(total), rows.shape[0]))].clone())


def spheres(ibt, leaves: dict):
    """The program's bounding spheres of ``leaves``: of the triangles
    (``bsphere_from_triangles``) or the particles themselves."""
    if "tris" in leaves:
        tr = leaves["tris"]
        return ibt.bsphere_from_triangles(tuple(tr[0]), tuple(tr[1]),
                                          tuple(tr[2]))
    return ibt.BSphere(tuple(leaves["x"]), leaves["r"])


def small_config(config: dict, leaves: int):
    """Cut a configuration of ``scene.configured`` to ``leaves`` leaves, and
    its capacities with them (in place; for the benchmark's own tests)."""
    key = "triangles" if "triangles" in config else "particles"
    config[key] = leaves
    config["capacity"] = 1024 * -(-16 * leaves // 1024)
    if "pair_capacity" in config:
        config["pair_capacity"] = 8192


def half_spheres(fn):
    """Half of the batch left out: spheres of the first half of the
    triangles only (a fault the benchmark's tests plant)."""
    def call(p1, p2, p3, *args, **kw):
        h = p1[0].shape[0] // 2
        return fn(*(tuple(c[:h] for c in p) for p in (p1, p2, p3)),
                  *args, **kw)
    return call


def half_particles(fn):
    """Half of the batch left out: the first half of the particles only
    (a fault the benchmark's tests plant)."""
    def call(xs, r, *args, **kw):
        h = r.shape[0] // 2
        return fn(tuple(c[:h] for c in xs), r[:h], *args, **kw)
    return call


class Step:
    layers = ("build", "traverse")
    # the configurations it runs (``harness.check_config``)
    runs = {"scene": ("closed surface", "particles"), "leaf": ("BSphere",),
            "node": ("BBox",), "dtype": ("float32",)}
    # the program's call whose answer a step returns, by ``traffic["query"]``
    calls = {"tiles_fixed": "traverse_tiles_fixed",
             "lvt_fixed": "traverse_lvt_single_fixed"}

    # what the benchmark's own tests take from a driver: a cell cut to a
    # size the CPU runs (``small``), the name of the program's call whose
    # answer a step returns (``answer_call``), and the call that takes the
    # batch with a wrapper that leaves out half of it (``half_batch``)
    @staticmethod
    def small(config: dict, traffic: dict, leaves: int):
        small_config(config, leaves)

    @classmethod
    def answer_call(cls, config: dict, traffic: dict) -> str:
        return cls.calls[traffic["query"]]

    @staticmethod
    def half_batch(config: dict, traffic: dict):
        if config["scene"] == "closed surface":
            return "bsphere_from_triangles", half_spheres
        return "BSphere", half_particles

    def __init__(self, config, traffic, seed, device, trace):
        self.config, self.traffic, self.trace = config, traffic, trace
        self.device = torch.device(device)
        self.moving = MovingScene(config, traffic, seed, self.device)
        self.times = []
        # events recorded inside the graph (external record nodes)
        self.marks = [torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(3)] \
            if trace and self.device.type == "cuda" else None

    def _query(self, bvh):
        ibt, cfg, moving = self.ibt, self.config, self.moving
        if self.traffic["query"] == "tiles_fixed":
            total, rows, overflow, checks = ibt.traverse_tiles_fixed(
                bvh, cfg["capacity"], alg=ibt.TileTraversal(**cfg["tile"]),
                pair_capacity=cfg["pair_capacity"])
            stat = torch.stack([total.double(), overflow.double(),
                                checks.double()])
        elif self.traffic["query"] == "lvt_fixed":
            total, rows = ibt.traverse_lvt_single_fixed(bvh, cfg["capacity"])
            stat = torch.stack([total.double(),
                                (total > cfg["capacity"]).double()])
        else:
            raise ValueError(f"unknown query {self.traffic['query']!r}")
        moving.t.add_(1.0)
        return stat, rows

    def _step(self):
        """The captured step: build, then query, timed inside the graph
        in a traced run."""
        m = self.marks
        if m:
            m[0].record()
        bvh = self.moving.build(self.ibt)
        if m:
            m[1].record()
        out = self._query(bvh)
        if m:
            m[2].record()
        return out

    def setup(self):
        import implicitbvh_tpu_torch as ibt
        self.ibt = ibt
        moving = self.moving
        if self.device.type != "cuda":
            self.stat, self.rows = self._step()
            moving.t.zero_()
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm up: loads every kernel
            for _ in range(self.traffic["warmup"]):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.stat, self.rows = self._step()
        for i in range(self.traffic["warmup"]):     # the replays warm too
            self.run(i)
        self.times.clear()
        moving.t.zero_()
        torch.cuda.synchronize()

    def run(self, i: int):
        if self.device.type != "cuda":
            self.stat, self.rows = self._step()
        else:
            self.graph.replay()
        v = self.stat.tolist()
        if self.marks:
            m = self.marks
            self.times.append((m[0].elapsed_time(m[1]),
                               m[1].elapsed_time(m[2])))
        self.last = v
        return int(v[0]), int(v[1]), v[2] if len(v) > 2 else None

    def keep(self, i: int):
        self.moving.keep(i, self.last[0], self.rows)

    def answer(self, i: int):
        return self.moving.kept[i]

    def inputs(self, i: int) -> dict:
        return self.moving.inputs(i)

    def layer_ms(self) -> dict:
        return {name: [t[k] for t in self.times]
                for k, name in enumerate(self.layers)} if self.times else {}

    def release(self):
        for name in ("graph", "stat", "rows"):
            self.__dict__.pop(name, None)
