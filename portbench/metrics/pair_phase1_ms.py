"""Device milliseconds per step of the two-tree route's ``tiles.phase1``
spans: the S1 x S2 supertile grid, the band bits (B1 with ``triangle``
off) and the run lists.  Read from the spans captured into the step's
graph (``layer_ms``, see ``steps/pair_graph.py``), the mean over the
window's steps; None where the program has no such span."""

import statistics


def read(tr):
    ms = tr.layer_ms.get("tiles.phase1")
    return statistics.fmean(ms) if ms else None
