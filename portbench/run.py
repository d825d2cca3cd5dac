#!/usr/bin/env python3
"""Run one cell of the benchmark of ``implicitbvh_tpu_torch`` on a CUDA card
and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (kernel build on a checkout's first run, the scene made on the card
from the seed, warm-up and capture) runs from the process's start to the
first timed step; then the window runs steps in a closed loop for
``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, with a profiled stretch of steps
after the window.  Once the window has closed and the program's state is freed, the
answers of steps drawn from the seed and of the last step are compared
with the plain reference; the numbers compared and their limits are the
last lines on standard error and the last key of the result.

Exits non-zero, printing no result, with no CUDA card (it never runs on the
CPU), when the program cannot be imported, or when JAX or the JAX package
was loaded.  Kernels build into the program's ``build/kernels/`` inside
the checkout.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))   # the program and the benchmark's package


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"found {torch.cuda.device_count()}: no result")
        return 2
    import implicitbvh_tpu_torch
    if not Path(implicitbvh_tpu_torch.__file__).resolve().is_relative_to(
            ROOT):
        harness.log(f"the program was imported from "
                    f"{implicitbvh_tpu_torch.__file__}, outside the checkout "
                    f"{ROOT}: no result")
        return 4
    result, compared = harness.run_cell(cell, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for name, (value, limit) in compared.items():
        harness.log(f"{name} {value} limit {limit}")
    print(harness.result_line(result, compared), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
