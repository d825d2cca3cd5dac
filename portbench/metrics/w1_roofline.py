"""W1's share of its roofline: ``counts.w1``'s bounds of the last
recorded count and write passes over the profiler's device time of the
``walk_*`` kernels per step, in percent of the published H100 peaks.  The
tests come from W1's diagnostic variant, run once more on the recorded
count pass's inputs after the window."""

import torch

from portbench.counts import w1


def read(tr):
    count, write = tr.recorded.get("w1.count"), tr.recorded.get("w1.write")
    ms, records = tr.kernel_ms(w1.KERNEL_PREFIX)
    if count is None or write is None or not records or ms <= 0:
        return None
    from implicitbvh_tpu_torch.ops.walk import walk_lanes
    (target, start_level, lanes), kw = count
    K = lanes.volume.batch_shape[0]
    diag = torch.zeros((K + 2, 4), dtype=torch.int32, device=tr.device)
    counts, _ = walk_lanes(target, start_level, lanes, **kw, diag=diag)
    tests = diag[:K].long().sum(0).tolist()
    total = int(counts.long().sum())
    self_walk = kw.get("dedup_ileaf") is not None
    passes = [w1.bound(target, lanes, tests[1], tests[2], 0, False,
                       self_walk)[0],
              w1.bound(target, lanes, tests[1], tests[2],
                       min(total, write[1]["capacity"]), True,
                       self_walk)[0]]
    # a step runs one count pass and one write pass
    return 100.0 * sum(passes) / (ms / tr.steps)
