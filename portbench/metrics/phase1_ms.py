"""Device milliseconds of phase 1 per profiled step: the program's
``tiles.phase1`` spans (superpairs, band bits B1, run lists) and
``rays.phase1`` spans (ray and leaf tiles, slab tests, run lists)."""

from portbench import spans


def read(tr):
    return spans.device_ms_per_step(tr, {"tiles.phase1", "rays.phase1"})
