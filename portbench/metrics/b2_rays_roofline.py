"""B2's share of its roofline, read as ``b2_roofline`` is, in the cells
whose end-to-end time is the device's busy time a step,
``step_device_ms``: a metric moves one end-to-end metric, which these
cells report in place of ``step_ms``."""

from portbench.metrics.b2_roofline import read  # noqa: F401
