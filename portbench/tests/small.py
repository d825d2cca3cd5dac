"""Cells cut to a size the CPU tests can run: the same configurations,
traffic and code, fewer leaves and rays, a short window."""

from portbench import harness

N_LEAVES = 1500
N_RAYS = 200


def small_cell(name: str, root=harness.ROOT, here=harness.HERE,
               leaves: int = N_LEAVES):
    cell = harness.load_cell(name, root, here)
    key = "triangles" if "triangles" in cell.config else "particles"
    cell.config[key] = leaves
    cell.config["capacity"] = 1024 * -(-16 * leaves // 1024)
    if "pair_capacity" in cell.config:
        cell.config["pair_capacity"] = 8192
    if "rays" in cell.traffic:
        cell.traffic["rays"], cell.traffic["bundles"] = N_RAYS, 4
        cell.traffic["warmup"] = min(cell.traffic["warmup"], 4)
    cell.traffic["trace"]["profile_steps"] = 2
    return cell


def cells():
    return [w["name"] for w in harness.load_spec()["workloads"]]
