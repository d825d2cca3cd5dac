"""Device operations (kernels, copies, sets) per step, from the
profiler's device records over the profiled steps: a count, which repeats
exactly for a given step."""


def read(tr):
    if not tr.steps or not tr.device_ops:
        return None
    return len(tr.device_ops) / tr.steps
