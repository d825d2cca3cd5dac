"""Cells cut to a size the CPU tests can run: the same configurations,
traffic and code, fewer leaves and rays (as each cell's step driver cuts
them, ``Step.small``), a short profiled stretch."""

from portbench import harness

N_LEAVES = 1500


def small_cell(name: str, root=harness.ROOT, here=harness.HERE,
               leaves: int = N_LEAVES):
    cell = harness.load_cell(name, root, here)
    harness.step_driver(cell.traffic, here).small(cell.config, cell.traffic,
                                                  leaves)
    cell.traffic["trace"]["profile_steps"] = 2
    return cell


def cells():
    return [w["name"] for w in harness.load_spec()["workloads"]]
