"""One run of one cell: set-up, the measured window, the traced metrics,
the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``BENCHMARK.json``'s ``workloads`` entry (the cell) names a
  configuration and a traffic mix; its ``configs`` entry names the
  configuration's file;
- ``traffic/<traffic>.json`` holds the mix's parameters, among them
  ``step``, the step driver ``steps/<step>.py`` that runs it, which
  declares the configurations it runs (``check_config``);
- ``reference/<kind>.py`` is the plain reference of the answer kind that
  a step's inputs name (``check.kind``);
- ``metrics/<metric>.py`` reads one per-layer metric from a traced run.
"""

from __future__ import annotations

import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "implicitbvh_tpu")
STEP_MARK = "portbench.step"
# CUDA runtime calls in which the host waits for the device (a copy to
# pageable host memory returns when the device has written it)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    here: Path = HERE           # the benchmark's folder: steps, metrics


def load_file(path: Path, package: str):
    """Import the module at ``path`` as ``<package>.<its stem>`` (dots in
    the stem become ``_``), so that it may import its package's
    modules."""
    name = f"{package}.{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


# the keys of a configuration whose values a step driver declares in its
# ``Step.runs``: any other value is refused, never run as one it declares
CONFIG_KEYS = ("scene", "leaf", "node", "dtype")


def check_config(config: dict, driver):
    """Raise ``ValueError`` where a configuration states a value of
    ``CONFIG_KEYS`` that ``driver`` (a step driver's ``Step``) does not
    declare in its ``runs``."""
    for key in CONFIG_KEYS:
        values = driver.runs.get(key, ())
        if config.get(key) not in values:
            raise ValueError(
                f"configuration {config.get('name')!r}: {key} = "
                f"{config.get(key)!r}; its step driver {driver.__module__} "
                f"runs only {', '.join(map(repr, values)) or 'none'}")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its
    configuration, traffic and the metrics it reports; ``here`` is the
    benchmark's folder."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    check_config(config, step_driver(traffic, here))
    return Cell(name, w["chips"], config, traffic,
                for_cell(spec["end_to_end"], name),
                for_cell(spec["per_layer"], name), here)


def step_driver(traffic: dict, here: Path = HERE):
    return load_file(here / "steps" / f"{traffic['step']}.py",
                     "portbench.steps").Step


def metric_reader(name: str, here: Path = HERE):
    return load_file(here / "metrics" / f"{name}.py",
                     "portbench.metrics").read


def check_steps(seed: int, traffic: dict) -> list:
    """Steps of the window whose answers the check compares, drawn from
    the seed (the window's last step is compared too)."""
    rng = random.Random(seed)
    lo, hi = traffic["check"]["first"], traffic["check"]["below"]
    return sorted(rng.sample(range(lo, hi), traffic["check"]["steps"]))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``implicitbvh_tpu_torch`` is not ``implicitbvh_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def percentile(values: list, q: int) -> float:
    """The ``q``-th percentile (inclusive method) of ``values``."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


# --------------------------------------------------------------------------
# the traced window
# --------------------------------------------------------------------------

@dataclass
class Trace:
    """What a traced run hands the per-layer readers.

    - ``steps``: the steps run under the profiler;
    - ``device_ops``: the profiler's device operations in those steps,
      ``(name, start_ns, duration_ns)`` (kernels, copies, sets);
    - ``window_ns``: the first profiled step's start to the last's end;
    - ``host_step_ns``: each profiled step's host duration;
    - ``sync_ns``: the CUDA runtime's calls that wait for the device
      (``WAITS``) within them;
    - ``layer_ms``: per-step CUDA-event times by layer over the steps
      before the profiled stretch;
    - ``window_steps``, ``window_s``, ``latencies``: the measured window
      before the profiled stretch: its steps, its wall seconds and each
      step's host seconds;
    - ``totals``, ``checks``: each step's count and leaf tests (None where
      the query gives none);
    - ``recorded``: the last call of each recorded kernel wrapper,
      ``{name: (args, kwargs)}``.
    """
    steps: int = 0
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    window_ns: tuple = (0, 0)
    host_step_ns: list = field(default_factory=list)
    sync_ns: int = 0
    layer_ms: dict = field(default_factory=dict)
    window_steps: int = 0
    window_s: float = 0.0
    latencies: list = field(default_factory=list)
    totals: list = field(default_factory=list)
    checks: list = field(default_factory=list)
    recorded: dict = field(default_factory=dict)
    device: object = None

    def kernel_ms(self, part: str):
        """``(device ms summed over the profiled steps, records)`` of the
        device operations whose name holds ``part``."""
        hits = [d for n, _, d in self.device_ops if part in n]
        return sum(hits) / 1e6, len(hits)

    def busy_ns(self) -> int:
        """Length of the union of the device operations' intervals within
        the window."""
        lo, hi = self.window_ns
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d in self.device_ops)
        busy, end = 0, lo
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def idle_gaps(self) -> list:
        """``(start_ns, end_ns)`` of the window's stretches with no device
        operation running."""
        lo, hi = self.window_ns
        gaps, end = [], lo
        for _, s, d in sorted(self.device_ops, key=lambda e: e[1]):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, s + d)
        if end < hi:
            gaps.append((end, hi))
        return [g for g in gaps if g[1] > g[0]]


RECORDED = (  # (module, attribute, name): the kernel wrappers a trace keeps
    ("implicitbvh_tpu_torch.traverse.tiles", "tile_run_counts", "b2"),
    ("implicitbvh_tpu_torch.traverse.ray_tiles", "tile_run_counts", "b2"),
    ("implicitbvh_tpu_torch.traverse.walk", "walk_lanes", "w1"),
)


def record_kernel_calls(tr: Trace):
    """Wrap the call sites of the kernels whose rooflines a trace reads, so
    that each call's arguments are kept (a graph's captured tensors hold
    the last replay's values).  Returns a function that undoes it."""
    saved = []
    for mod_name, attr, name in RECORDED:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def keyed(*args, _fn=fn, _name=name, **kw):
            if _name == "w1":   # the count pass and the write pass
                _name += ".write" if kw.get("capacity", 0) > 0 else ".count"
            tr.recorded[_name] = (args, kw)
            return _fn(*args, **kw)
        setattr(mod, attr, keyed)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def profile_events(prof) -> list:
    """``(name, on_device, start_ns, duration_ns)`` of every record of a
    finished ``torch.profiler.profile``, host and device on one clock."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.duration_ns()) for e in prof.profiler.kineto_results.events()]


def device_busy_ns(prof, window_ns: tuple) -> int:
    """Nanoseconds within ``window_ns`` in which a device operation of the
    finished ``torch.profiler.profile`` ran."""
    from torch.autograd import DeviceType
    ops = [("", e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return Trace(device_ops=ops, window_ns=window_ns).busy_ns()


def read_profile(prof, tr: Trace):
    """Fill ``tr`` from a finished ``torch.profiler.profile`` whose steps
    ran under ``record_function(STEP_MARK)`` (whose device-side copy of
    that mark is no device operation)."""
    marks, host = [], []
    for name, on_device, s, d in profile_events(prof):
        if name == STEP_MARK:
            if not on_device:
                marks.append((s, d))
        elif on_device:
            tr.device_ops.append((name, s, d))
        else:
            host.append((name, s, d))
    if not marks:
        return
    tr.window_ns = (min(s for s, _ in marks),
                    max(s + d for s, d in marks))
    lo, hi = tr.window_ns
    tr.device_ops = [e for e in tr.device_ops if lo <= e[1] < hi]
    tr.host_ops = [e for e in host if e[1] < hi and e[1] + e[2] > lo]
    tr.host_step_ns = [d for _, d in marks]
    tr.sync_ns = sum(d for n, s, d in tr.host_ops
                     if n.startswith(WAITS) and lo <= s < hi)


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time in the traced
    window, and the idle time by what the host was doing (the innermost
    host operation over each gap's middle), seconds as measured."""
    by_op = {}
    for n, _, d in tr.device_ops:
        by_op[n] = by_op.get(n, 0) + d
    by_host = {}
    for a, b in tr.idle_gaps():
        mid = (a + b) // 2
        inner = [(d, n) for n, s, d in tr.host_ops if s <= mid < s + d]
        label = min(inner)[1] if inner else "python (no profiled op)"
        by_host[label] = by_host.get(label, 0) + (b - a)
    top = lambda m: [[n[:120], v / 1e9] for n, v in
                     sorted(m.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, check_at=None, min_steps: int = 1) -> tuple:
    """Run ``cell`` once.  Returns ``(result, compared)``: the result line's
    object and ``{number: (value, limit)}`` of the comparison.

    ``device`` is ``"cuda"`` on the card; the tests pass ``"cpu"`` (the
    command itself never runs on the CPU).  ``check_at`` replaces the
    steps drawn for the check; the window runs at least ``min_steps``
    steps."""
    import torch
    from . import check
    marks = [("imports", time.time())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.cuda.synchronize()
        marks.append(("cuda init", time.time()))
        from implicitbvh_tpu_torch.ops import _build
        built = _build.build()
        marks.append((f"kernel build ({', '.join(built) or 'none'})",
                      time.time()))
    tr = Trace(device=dev) if trace else None
    undo = record_kernel_calls(tr) if trace else (lambda: None)
    step = step_driver(cell.traffic, cell.here)(cell.config, cell.traffic,
                                                 seed, dev, trace)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("inputs on the card", time.time()))
    step.setup()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("program set-up, warm-up, capture", time.time()))
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                               in zip([("start", t0)] + marks, marks)))
    want = set(check_at if check_at is not None
               else check_steps(seed, cell.traffic))

    lat, failed, totals, checks = [], 0, [], []
    n_prof = cell.traffic["trace"]["profile_steps"] if trace else 0

    def one(i):
        nonlocal failed
        s0 = time.perf_counter()
        total, overflow, nchk = step.run(i)
        s1 = time.perf_counter()
        lat.append(s1 - s0)
        totals.append(total)
        checks.append(nchk)
        if overflow:
            failed += 1
        if i in want:
            step.keep(i)
        return s1

    setup_s = time.time() - t0
    # an end-to-end metric of the device's timeline is read over the whole
    # window, which then runs under a profiler of the device alone
    timeline = cuda and not trace and any(
        m["source"] == "device_trace" for m in cell.end_to_end)
    if timeline:
        from torch.profiler import ProfilerActivity, profile
        wprof = profile(activities=[ProfilerActivity.CUDA])
        wprof.__enter__()
        torch.cuda.synchronize()
    w0 = time.perf_counter()
    w_ns = time.time_ns()
    deadline = w0 + seconds
    i, end = 0, w0
    while end < deadline or i < min_steps:
        end = one(i)
        i += 1
    w_steps, w_end = i, end
    busy_ns = None
    if timeline:
        torch.cuda.synchronize()
        e_ns = time.time_ns()
        p0 = time.perf_counter()
        wprof.__exit__(None, None, None)
        busy_ns = device_busy_ns(wprof, (w_ns, e_ns))
        del wprof
        log(f"device busy {busy_ns / 1e9:.4f} s of the window's "
            f"{(e_ns - w_ns) / 1e9:.4f} s (the profile read in "
            f"{time.perf_counter() - p0:.1f} s)")
    if trace:
        # the profiled stretch comes last: the profiler's device tracing
        # slows the kernels it records, which the layers' events would read
        layers = step.layer_ms()
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            for _ in range(n_prof):
                with record_function(STEP_MARK):
                    end = one(i)
                i += 1
            if cuda:
                torch.cuda.synchronize()
    steps = i
    window_s = end - w0
    step.keep(steps - 1)
    want = sorted((want & set(range(steps))) | {steps - 1})
    # the run's peak through the window's close: a captured step's
    # temporaries live in the graph's pool, which the allocated count does
    # not hold while replays run, so the warm-up's peak is the step's
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    for m in cell.end_to_end:
        v = {"setup_s": setup_s,
             "step_ms": 1e3 * window_s / steps,
             "step_p95_ms": 1e3 * percentile(lat, 95),
             "step_device_ms": None if busy_ns is None
             else busy_ns / 1e6 / steps,
             "peak_mem_gib": peak / 2 ** 30}.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    card = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak,
            "power_limit": power_limit() if cuda else "not measured"}
    log(f"{cell.name}: {steps} steps in {window_s:.4f} s, p95 over "
        f"{len(lat)} step latencies, {failed} overflowed; "
        f"{card['kind']}, power limit {card['power_limit']}")
    result = {"correct": False, "attempted": steps, "failed": failed}
    if trace:
        read_profile(prof, tr)
        tr.steps = n_prof
        tr.layer_ms = layers
        tr.window_steps, tr.window_s = w_steps, w_end - w0
        tr.latencies = lat[:w_steps]
        tr.totals, tr.checks = totals, checks
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], cell.here)(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
                log(f"  {m['name']} = {v!r} {m['unit']} (power limit "
                    f"{card['power_limit']})")
            else:
                log(f"  {m['name']}: nothing to read (left out)")
        card["busy_s"] = tr.busy_ns() / 1e9
        card["window_s"] = (tr.window_ns[1] - tr.window_ns[0]) / 1e9
        result["breakdown"] = breakdown(tr)
    undo()

    # the program's state goes before the reference runs
    step.release()
    if cuda:
        torch.cuda.empty_cache()
    worst = 0
    for j in want:
        total, rows = step.answer(j)
        inputs = step.inputs(j)
        kind = check.kind(inputs["kind"], cell.here)
        off = check.keys_off(total, *kind.keys_of(rows, inputs),
                             kind.reference_keys(inputs, torch.float32))
        log(f"  step {j}: count {total}, pairs_off {off}")
        worst = max(worst, off)
    compared = {"pairs_off": (worst, check.LIMITS["pairs_off"])}
    result["correct"] = all(v <= lim for v, lim in compared.values())
    result["metrics"] = metrics
    result["device"] = card
    return result, compared


def result_line(result: dict, compared: dict) -> str:
    """The one JSON line, with the numbers compared last."""
    out = dict(result)
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return json.dumps(out)
