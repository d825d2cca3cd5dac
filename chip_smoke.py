#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``implicitbvh_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the three CUDA kernels from ``implicitbvh_tpu_torch/csrc/`` into
``build/kernels/`` (one ``nvcc`` per source, all at once), then:

1. runs each kernel and its plain PyTorch version on the same inputs on the
   card -- the inputs its stage gets on a small scene (tile 32) and on the
   1M-triangle bench scene -- and requires exact equality (the predicates
   are comparisons of identically rounded float32 values, the outputs are
   integers);
2. drives the main path at the bench scene: 2^20 triangles ->
   ``bsphere_from_triangles`` -> ``build`` -> ``traverse_tiles_fixed``
   (capacity 131072, ``TileTraversal(row_cap=4, pair_cap=32)``) with every
   launch count set to 0 just before and read just after; it requires no
   overflow, every pair to satisfy the sphere predicate, no duplicate pair
   and at least one launch of each kernel;
3. runs a 65,536-triangle scene through the path on the card and on the CPU
   (plain versions) and requires identical contacts, total, overflow and
   ``num_checks``;
4. times (CUDA events, median of 7 after a warm-up) the 1M step end to end
   and by stage, each kernel at its 1M inputs and each plain version at the
   same inputs, and profiles the step (device time by kernel, device busy
   share).

It prints one ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises and
exits non-zero; so does a machine without a CUDA device.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

N_BENCH = 1 << 20          # triangles of the bench scene
N_CROSS = 1 << 16          # triangles of the card-vs-CPU scene
N_SMALL = 4096             # triangles of the small kernel-check scene
TPU_BENCH_CONTACTS = 57868  # the JAX package's total on this scene (TPU v5e)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
FLOPS_PER_TEST = {"sphere": 11, "box": 6}   # sub/mul/add/compare per leaf test


def synth_triangles(n_tri: int, seed: int = 0):
    """Random triangle soup at about unit density, as (N, 3) float32 arrays
    (the bench scene's generator)."""
    rng = np.random.default_rng(seed)
    scale = float(n_tri) ** (1.0 / 3.0)
    c = (rng.random((n_tri, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    return c, c + e1, c + e2


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def profile_step(torch, run_step, step_ms, card, steps=3):
    """Device time by kernel over a few steps (torch.profiler) and the
    device's busy share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and dev_us(e) > 0]
    if not kern:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(dev_us(e) for e in kern) / steps / 1e3
    log(f"profile: device busy {busy:.4f} ms per step, "
        f"{100 * busy / step_ms:.1f}% of the {step_ms:.4f} ms step, "
        f"{sum(e.count for e in kern) // steps} device ops per step [{card}]")
    for e in sorted(kern, key=dev_us, reverse=True)[:16]:
        log(f"  {dev_us(e) / steps / 1e3:9.4f} ms  x{e.count // steps:<4d} "
            f"{e.key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import implicitbvh_tpu_torch as ib
    from implicitbvh_tpu_torch import ops
    from implicitbvh_tpu_torch.ops import _build
    from implicitbvh_tpu_torch.traverse import tiles

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(sorted(logs)) or 'cached'})")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels = {  # name -> (wrapper, plain, source, TPU kernel it replaces)
        "subtile_band_bits": (
            ops.subtile_band_bits, ops.subtile_band_bits_plain,
            "implicitbvh_tpu_torch/csrc/band_bits.cu",
            "implicitbvh_tpu/ops/subtile.py:150"),
        "tile_run_counts": (
            ops.tile_run_counts, ops.tile_run_counts_plain,
            "implicitbvh_tpu_torch/csrc/run_counts.cu",
            "implicitbvh_tpu/ops/tile_contact.py:653"),
        "tile_group_emit": (
            ops.tile_group_emit, ops.tile_group_emit_plain,
            "implicitbvh_tpu_torch/csrc/group_emit.cu",
            "implicitbvh_tpu/ops/tile_contact.py:1109"),
    }

    @contextlib.contextmanager
    def recorded_inputs():
        """Record the arguments each kernel wrapper gets from the path."""
        seen = {}
        saved = {name: getattr(tiles, name) for name in kernels}

        def recorder(name, fn):
            def call(*args, **kw):
                seen[name] = (args, kw)
                return fn(*args, **kw)
            return call

        for name, fn in saved.items():
            setattr(tiles, name, recorder(name, fn))
        try:
            yield seen
        finally:
            for name, fn in saved.items():
                setattr(tiles, name, fn)

    def to_dev(tris, device):
        return tuple(tuple(torch.as_tensor(np.ascontiguousarray(p[:, k]),
                                           device=device) for k in range(3))
                     for p in tris)

    def step(p1, p2, p3, capacity, alg):
        spheres = ib.bsphere_from_triangles(p1, p2, p3)
        bvh = ib.build(spheres)
        return spheres, ib.traverse_tiles_fixed(bvh, capacity, alg=alg)

    def outputs_of(name, result):
        if name == "tile_group_emit":  # contacts compared as a sorted set
            gi, gj, total, flags = result
            n = int(total.clamp(max=gi.shape[0]))
            pairs = (gi[:n].long() << 32) | gj[:n].long()
            return [pairs.sort().values, total.reshape(1), flags.reshape(1)]
        return list(result) if isinstance(result, tuple) else [result]

    def check_kernels(seen, label):
        errs = {}
        for name, (wrapper, plain, _, _) in kernels.items():
            args, kw = seen[name]
            got = outputs_of(name, wrapper(*args, **kw))
            want = outputs_of(name, plain(*args, **kw))
            torch.cuda.synchronize()
            err = 0
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g, w):
                    raise AssertionError(
                        f"{name} differs from its plain version ({label})")
                if g.numel():
                    err = max(err, int((g.long() - w.long()).abs().max()))
            errs[name] = err
            log(f"{label}: {name} kernel == plain (exact)")
        return errs

    alg = ib.TileTraversal(row_cap=4, pair_cap=32)

    # 1. kernels against their plain versions: small scene, tile 32
    small_alg = ib.TileTraversal(tile=32, row_cap=4, pair_cap=32)
    with recorded_inputs() as seen:
        step(*to_dev(synth_triangles(N_SMALL, seed=1), dev), 4096, small_alg)
    check_kernels(seen, f"small scene ({N_SMALL} triangles, tile 32)")

    # 2. the main path at the bench scene, launch counts read around it
    capacity = max(1 << (math.ceil(math.log2(N_BENCH)) - 3), 4096)
    tris = to_dev(synth_triangles(N_BENCH), dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    spheres = ib.bsphere_from_triangles(*tris)
    bvh = ib.build(spheres)
    torch.cuda.set_sync_debug_mode("error")  # the fixed path never syncs
    try:
        total, contacts, overflow, num_checks = ib.traverse_tiles_fixed(
            bvh, capacity, alg=alg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {name: k[0].launches for name, k in kernels.items()}
    total, ov = int(total), int(overflow)
    log(f"bench scene: {N_BENCH} triangles, {total} contacts "
        f"(the JAX package reported {TPU_BENCH_CONTACTS} on a TPU v5e), "
        f"overflow {ov}, num_checks {float(num_checks):.0f}, "
        f"launches {launches}")
    if ov != 0:
        raise AssertionError(f"overflow {ov} on the bench scene")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    c = contacts[:total].long() - 1
    if not bool((c[:, 0] < c[:, 1]).all()):
        raise AssertionError("contacts are not sorted (min, max) pairs")
    if torch.unique(c[:, 0] * N_BENCH + c[:, 1]).numel() != total:
        raise AssertionError("duplicate contacts")
    xs, r = spheres.xs, spheres.r
    dx, dy, dz = (x[c[:, 0]] - x[c[:, 1]] for x in xs)
    rr = r[c[:, 0]] + r[c[:, 1]]
    if not bool((dx * dx + dy * dy + dz * dz <= rr * rr).all()):
        raise AssertionError("a contact fails the sphere predicate")
    log("bench scene: every contact satisfies the sphere predicate, "
        "no duplicates, no host sync in traverse_tiles_fixed")

    with recorded_inputs() as seen_1m:
        step(*tris, capacity, alg)
    errs = check_kernels(seen_1m, f"bench scene ({N_BENCH} triangles)")

    # 3. the whole path on the card against the port on the CPU
    cross = synth_triangles(N_CROSS, seed=2)
    cap_x = max(1 << (math.ceil(math.log2(N_CROSS)) - 3), 4096)
    res = []
    for d in (dev, torch.device("cpu")):
        tot, con, ovx, nc = step(*to_dev(cross, d), cap_x, alg)[1]
        tot = int(tot)
        pairs = sorted(map(tuple, con[:tot].cpu().tolist()))
        res.append((tot, pairs, int(ovx), float(nc)))
    if res[0] != res[1]:
        raise AssertionError(f"card and CPU disagree on the {N_CROSS}-"
                             "triangle scene")
    log(f"cross scene: {N_CROSS} triangles, card == CPU: {res[0][0]} "
        f"contacts, overflow {res[0][2]}, num_checks {res[0][3]:.0f}")

    # 4. timings at the bench scene
    def time_ms(fn, reps=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    step_ms = time_ms(lambda: step(*tris, capacity, alg))
    log(f"time: bench step end to end {step_ms:.4f} ms [{card}]")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(name, args, kw):
        """(bound_ms, bound_by): the larger of the bytes over the memory
        rate and the float operations this run's data needs over the fp32
        rate."""
        if name == "subtile_band_bits":
            sub, tl, si, sj, nsp = args
            out_b = si.shape[0] * 32 * 32 * 4
            ar = torch.arange(32, device=dev)
            tii = si[:, None].long() * 32 + ar
            tjj = sj[:, None].long() * 32 + ar
            live = (torch.arange(si.shape[0], device=dev) < nsp)[:, None, None]
            valid = live & (tii < sub.shape[1])[:, :, None] & \
                (tjj < tl.shape[1])[:, None, :] & \
                (tii[:, :, None] <= tjj[:, None, :])
            ops_n = int(valid.sum()) * sub.shape[2] * 6
            b = nbytes(sub, tl, si, sj, nsp) + out_b
        elif name == "tile_run_counts":
            a_idx, run_idx, bm, nsteps, fields = args
            b = nbytes(a_idx, run_idx, bm, nsteps, fields) + \
                2 * run_idx.shape[0] * kw["R"] * 4
            ops_n = float(num_checks) * FLOPS_PER_TEST[kw["mask_kind"]]
        else:
            a_idx, b_idx, nsteps, fields = args
            G = fields.shape[2]
            W = b_idx.shape[0] // a_idx.shape[0]
            e = torch.arange(b_idx.shape[0], device=dev)
            live = (((b_idx >> 20) & 0xFF) > 0) & \
                ((e // W) < nsteps.clamp(max=a_idx.shape[0]))
            band = (b_idx >> 16) & 0xF
            nbands = sum(((band >> k) & 1) for k in range(4))
            tests = int((nbands * live).sum()) * (G // 4) * G
            ops_n = tests * FLOPS_PER_TEST[kw["mask_kind"]]
            b = nbytes(a_idx, b_idx, nsteps, fields) + 2 * kw["CAP"] * 4 + 4
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = ops_n / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def stage_ms():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        s = ib.bsphere_from_triangles(*tris)
        ev[1].record()
        b = ib.build(s)
        ev[2].record()
        ib.traverse_tiles_fixed(b, capacity, alg=alg)
        ev[3].record()
        ev[3].synchronize()
        return [ev[k].elapsed_time(ev[k + 1]) for k in range(3)]

    stages = [stage_ms() for _ in range(7)]
    log("time: stages (median of 7) "
        + ", ".join(f"{n} {statistics.median(t[k] for t in stages):.4f} ms"
                    for k, n in enumerate(("bounding spheres", "build",
                                           "traversal")))
        + f" [{card}]")
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        step(*tris, capacity, alg)
        host.append((time.perf_counter() - h0) * 1e3)
    torch.cuda.synchronize()
    log(f"time: host enqueue of one step {statistics.median(host):.4f} ms "
        f"(median of 7) [{card}]")
    profile_step(torch, lambda: step(*tris, capacity, alg), step_ms, card)

    rows = []
    for name, (wrapper, plain, source, replaces) in kernels.items():
        args, kw = seen_1m[name]
        k_ms = time_ms(lambda: wrapper(*args, **kw))
        p_ms = time_ms(lambda: plain(*args, **kw), reps=5)
        b_ms, b_by = bound(name, args, kw)
        log(f"time: {name} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}) [{card}]")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
