"""A two-body contact step on the tile pair route, run eagerly: body 1, a
cloud of particles at rest, is built once at set-up; body 2, a second
cloud, moves rigidly through it, and each step builds body 2 and calls
``traverse_tiles_pair_fixed(bvh1, bvh2, capacity, ...)`` with the
configuration's ``TileTraversal``, ``capacity`` and ``pair_capacity``.

The configuration's ``bodies`` give each cloud's ``particles``,
``spacing`` and ``radius`` (``scene.particles``), drawn from its
``scene_seed``; the run's seed draws each body's leaf order.  Body 2
starts centred on body 1 and swings along x by ``traffic["move"]``'s
``amplitude`` times body 1's side, over ``period`` steps
(``scene.moved`` with one phase and one direction for every particle).
"""

from __future__ import annotations

import torch

from .. import scene
from .self_graph import half_particles


class Step:
    layers = ("traverse",)
    # the configurations it runs (``harness.check_config``)
    runs = {"scene": ("particle pair",), "leaf": ("BSphere",),
            "node": ("BBox",), "dtype": ("float32",)}

    # for the benchmark's own tests (see ``self_graph.Step``)
    @staticmethod
    def small(config: dict, traffic: dict, leaves: int):
        for body in config["bodies"]:
            body["particles"] = min(body["particles"], leaves)

    @staticmethod
    def answer_call(config: dict, traffic: dict) -> str:
        return "traverse_tiles_pair_fixed"

    @staticmethod
    def half_batch(config: dict, traffic: dict):
        return "BSphere", half_particles

    def __init__(self, config, traffic, seed, device, trace):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        sg = scene.generator(config["scene_seed"], self.device)
        g = scene.generator(seed, self.device)
        one, two = config["bodies"]
        self.one = scene.particles(one["particles"], sg, self.device,
                                   spacing=one["spacing"],
                                   radius=one["radius"]).shuffled(g)
        self.two = scene.particles(two["particles"], sg, self.device,
                                   spacing=two["spacing"],
                                   radius=two["radius"]).shuffled(g)
        side = [b["particles"] ** (1.0 / 3.0) * b["spacing"]
                for b in (one, two)]
        self.rest = self.two.points + 0.5 * (side[0] - side[1])
        m = self.rest.shape[1]
        self.phase = torch.zeros((m,), device=self.device)
        self.direction = torch.zeros((3, m), device=self.device)
        self.direction[0] = 1.0
        self.swing = traffic["move"]["amplitude"] * side[0]
        self.kept = {}

    def at(self, i: int) -> torch.Tensor:
        """Body 2's centres at step ``i``."""
        t = torch.tensor(float(i), dtype=torch.float32, device=self.device)
        return scene.moved(self.rest, self.phase, self.direction, t,
                           self.swing, self.traffic["move"]["period"])

    def setup(self):
        import implicitbvh_tpu_torch as ibt
        self.ibt = ibt
        self.bvh1 = ibt.build(ibt.BSphere(tuple(self.one.points),
                                          self.one.radii),
                              getattr(ibt, self.config["node"]))
        for i in range(self.traffic["warmup"]):
            self.run(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, i: int):
        ibt, cfg = self.ibt, self.config
        bvh2 = ibt.build(ibt.BSphere(tuple(self.at(i)), self.two.radii),
                         getattr(ibt, cfg["node"]))
        total, rows, overflow, checks = ibt.traverse_tiles_pair_fixed(
            self.bvh1, bvh2, cfg["capacity"],
            alg=ibt.TileTraversal(**cfg["tile"]),
            pair_capacity=cfg["pair_capacity"])
        stat = torch.stack([total.double(), overflow.double(),
                            checks.double()]).tolist()
        self.last = (int(stat[0]), rows)
        return int(stat[0]), int(stat[1]), stat[2]

    def keep(self, i: int):
        total, rows = self.last
        self.kept[i] = (total, rows[:max(0, min(total, rows.shape[0]))]
                        .clone())

    def answer(self, i: int):
        return self.kept[i]

    def inputs(self, i: int) -> dict:
        return {"kind": "pair", "x1": self.one.points, "r1": self.one.radii,
                "x2": self.at(i), "r2": self.two.radii}

    def layer_ms(self) -> dict:
        return {}

    def release(self):
        for name in ("bvh1", "last"):
            self.__dict__.pop(name, None)
