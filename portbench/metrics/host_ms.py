"""Host milliseconds per step not spent waiting on the device: each
profiled step's host time less the CUDA runtime's calls that wait for it
(synchronisations and copies to the host; the profiler's host records,
whose own cost is in it)."""


def read(tr):
    if not tr.steps or not tr.host_step_ns:
        return None
    return (sum(tr.host_step_ns) - tr.sync_ns) / tr.steps / 1e6
