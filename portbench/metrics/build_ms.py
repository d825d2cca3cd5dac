"""Device milliseconds of the build per step (move, bounding spheres,
``build``): CUDA events around it, the mean over the traced run's steps."""

import statistics


def read(tr):
    ms = tr.layer_ms.get("build")
    return statistics.fmean(ms) if ms else None
