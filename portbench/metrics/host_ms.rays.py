"""``host_ms`` (see its reader) in the cells whose end-to-end time is the
device's busy time a step, ``step_device_ms``: a metric moves one
end-to-end metric, which these cells report in place of ``step_ms``."""

from portbench.metrics.host_ms import read  # noqa: F401
