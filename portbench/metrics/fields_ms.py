"""Device milliseconds per step of the program's ``tiles.fields`` spans:
each body's leaves tiled into field sets and tile bounds, on every call,
the body at rest too.  Read from the spans captured into the step's graph
(``layer_ms``, see ``steps/pair_graph.py``), the mean over the window's
steps; None where the program has no such span."""

import statistics


def read(tr):
    ms = tr.layer_ms.get("tiles.fields")
    return statistics.fmean(ms) if ms else None
