"""A ray-bundle step through the public API: ``traverse_rays(bvh, points,
directions, cache=previous)`` on the default tile route, against a BVH
built once at set-up (as the reference library's ray benchmark traverses a
prebuilt tree).

The scene is the configuration's (its order drawn from the seed).  A pool
of ``traffic["bundles"]`` bundles of ``traffic["rays"]`` rays is made on
the device at set-up from the mix's own ``pool_seed``, the same in every
run, so every run does the same work: a bundle dense enough to send
``traverse_rays`` past its tile caps into the walk is in every run's mix.
The run's seed draws the order in which the bundles are sent; step ``i``
takes the ``i % bundles``-th of that order.  The warm-up sends every
bundle once.  ``traverse_rays`` grows its capacities on overflow and
reads the count to the host itself.  A traced run records CUDA events
around the query.
"""

from __future__ import annotations

import torch

from .. import scene
from . import self_graph


def half_rays(fn):
    """Half of the batch left out: the first half of the rays only (a
    fault the benchmark's tests plant)."""
    def call(bvh, p, d, *args, **kw):
        h = p.shape[1] // 2
        return fn(bvh, p[:, :h], d[:, :h], *args, **kw)
    return call


class Step:
    layers = ("traverse",)
    # the configurations it runs (``harness.check_config``): those of the
    # captured steps, on the same scenes
    runs = self_graph.Step.runs

    # for the benchmark's own tests (see ``self_graph.Step``)
    @staticmethod
    def small(config: dict, traffic: dict, leaves: int):
        self_graph.small_config(config, leaves)
        traffic["rays"], traffic["bundles"] = 200, 4
        traffic["warmup"] = min(traffic["warmup"], 4)

    @staticmethod
    def answer_call(config: dict, traffic: dict) -> str:
        return "traverse_rays"

    @staticmethod
    def half_batch(config: dict, traffic: dict):
        return "traverse_rays", half_rays

    def __init__(self, config, traffic, seed, device, trace):
        self.config, self.traffic, self.trace = config, traffic, trace
        self.device = torch.device(device)
        self.scene, g = scene.configured(config, seed, self.device)
        self.leaves = self.scene.leaves(self.scene.points)
        self.points, self.directions = scene.ray_pool(
            traffic["bundles"], traffic["rays"], self.scene.points,
            scene.generator(traffic["pool_seed"], self.device))
        self.order = torch.randperm(traffic["bundles"], generator=g,
                                    device=self.device).tolist()
        self.times, self.kept, self.prev = [], {}, None
        self.marks = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)] \
            if trace and self.device.type == "cuda" else None

    def setup(self):
        import implicitbvh_tpu_torch as ibt
        self.ibt = ibt
        self.bvh = ibt.build(self_graph.spheres(ibt, self.leaves),
                             getattr(ibt, self.config["node"]))
        for i in range(self.traffic["warmup"]):
            self.run(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.times.clear()

    def bundle(self, i: int) -> int:
        return self.order[i % self.traffic["bundles"]]

    def run(self, i: int):
        k = self.bundle(i)
        m = self.marks
        if m:
            m[0].record()
        res = self.ibt.traverse_rays(self.bvh, self.points[k],
                                     self.directions[k], cache=self.prev)
        if m:       # the count's read has waited for the query
            m[1].record()
            m[1].synchronize()
            self.times.append(m[0].elapsed_time(m[1]))
        self.prev = res
        return int(res.num_contacts), 0, float(res.num_checks)

    def keep(self, i: int):
        total = int(self.prev.num_contacts)
        rows = self.prev.cache1
        self.kept[i] = (total, rows[:max(0, min(total, rows.shape[0]))]
                        .clone())

    def answer(self, i: int):
        return self.kept[i]

    def inputs(self, i: int) -> dict:
        k = self.bundle(i)
        return {"kind": "rays", **self.leaves, "p": self.points[k],
                "d": self.directions[k]}

    def layer_ms(self) -> dict:
        return {"traverse": list(self.times)} if self.times else {}

    def release(self):
        self.__dict__.pop("bvh", None)
        self.prev = None
