#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference, computed in a lower precision than the configuration states
(bfloat16 for float32), put in the program's place at a cell's own sizes.
It has to come out not correct: its ``pairs_off`` against the float32
reference must pass the limit on every seed.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the cell's inputs as a run does (the same draws),
takes the steps a run would check, and prints one JSON line per step: the
control's ``pairs_off`` beside the limit.  The reference and the rows of
its keys come from the inputs' answer kind (``check.kind``).  The
benchmark's own runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control(cell, seed: int, dtype, device, steps=None) -> list:
    """``[(step, pairs_off, limit)]`` of the control at ``cell``'s sizes."""
    import torch
    from portbench import check, harness
    drv = harness.step_driver(cell.traffic, cell.here)(
        cell.config, cell.traffic, seed, torch.device(device), False)
    out = []
    for i in steps or harness.check_steps(seed, cell.traffic):
        inputs = drv.inputs(i)
        kind = check.kind(inputs["kind"], cell.here)
        want = kind.reference_keys(inputs, torch.float32)
        got = kind.reference_keys(inputs, dtype)
        off = check.keys_off(got.shape[0],
                             *kind.keys_of(kind.rows_of(got, inputs), inputs),
                             want)
        out.append((i, off, check.LIMITS["pairs_off"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    dtype = torch.bfloat16
    fails = True
    for seed in args.seeds:
        for step, off, limit in control(cell, seed, dtype, "cuda"):
            fails &= off > limit
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "dtype": "bfloat16", "step": step,
                              "pairs_off": off, "limit": limit}),
                  flush=True)
    print(json.dumps({"workload": args.workload, "control_fails": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
