"""Device milliseconds of the program's ``traverse`` spans per profiled
step: the public call, every fixed run of the growth loop and the walk it
may end in."""

from portbench import spans


def read(tr):
    return spans.device_ms_per_step(tr, {"traverse"})
