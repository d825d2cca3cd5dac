"""Device milliseconds of the traversal per step (the query call): CUDA
events around it, the mean over the traced run's steps."""

import statistics


def read(tr):
    ms = tr.layer_ms.get("traverse")
    return statistics.fmean(ms) if ms else None
