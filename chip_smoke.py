#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``implicitbvh_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``implicitbvh_tpu_torch/csrc/`` into
``build/kernels/`` (one ``nvcc`` per source, all at once), then drives both
routes of tile self-contact and of two-tree contact: the two-phase route
(kernels B1 band bits, B2 counts, B3 emit with its plan scan) and the
pair-granularity fallback (B1, the whole compaction ``compact_flat``: B5's
count pass and its flat write pass, B4 grouped slots), which small
capacities and grown slot caps take; both routes of the batch ray query (two-phase: B2
with a ray mask and moment words, the moment decode, B3 with a ray mask;
fallback: B4 with a ray mask); the public ``traverse`` dispatch; the
leaf-vs-tree walks (kernel W1, few lanes split by subtree), where growth
past the slot caps ends; breadth-first traversal (self, two trees, rays;
torch ops) and depth-first self-contact (kernel W2, each lane's stack in
rounds of work items).  B6
(per-pair slots of a packed pair list) and ``tile_compact`` (B5's padded
slots, which ``compact_flat`` replaces on the path) are on no path and are
held against their plain versions at the path's inputs only.

1. runs each kernel and its plain PyTorch version on the same inputs on the
   card -- the inputs its stage gets on a small scene (tile 32) on both
   routes -- and requires exact equality (the predicates are comparisons of
   identically rounded float32 values, the outputs are integers, B3's and
   ``compact_flat``'s in full; slot lanes past a pair's count and B2's word
   rows of dead pairs are undefined and not compared);
2. drives the two-phase route at the bench scene: 2^20 triangles ->
   ``bsphere_from_triangles`` -> ``build`` -> ``traverse_tiles_fixed``
   (capacity 131072, ``TileTraversal(row_cap=4, pair_cap=32)``) with every
   launch count set to 0 just before and read just after; it requires no
   overflow, every pair to satisfy the sphere predicate, no duplicate pair,
   no host sync and at least one launch of B1, B2 and B3;
3. drives the fallback on the same BVH (``TileTraversal(row_cap=32,
   pair_cap=512)``, the caps two slot-cap growths reach) the same way; it
   requires what phase 2 does, launches of B1, B4 and ``compact_flat`` and
   none of B2, B3 and ``tile_compact``, and the contact set and total of
   phase 2;
4. holds each kernel against its plain version at the bench scene's
   inputs of its route;
5. runs a 65,536-triangle scene through both routes on the card and on the
   CPU (plain versions) and requires identical contacts, total, overflow
   and ``num_checks``; runs the README demo on the card through
   ``traverse_tiles`` with default options (capacity 64, so the fallback);
6. holds each ray variant of B2 (``moments=True``), B3, B4 and B6 against
   its plain version on a small ray scene (tile 32; sphere and box leaves;
   rays with zero direction components and rays in face planes), and B2
   with ``moments=True`` on the small scene's self-contact inputs;
7. drives the ray query at full width through
   ``traverse_rays_tiles_fixed``: 2^18 triangles -> spheres -> ``build``,
   100,000 rays, capacity 2^18, the ray defaults (``row_cap=8, emit_w=8,
   decode_k=8``), launch counts set to 0 just before and read just after;
   it requires no overflow, no duplicate (leaf, ray) pair, no host sync,
   at least one launch of B2 and B3, and the hit set of a brute force on
   the card (``isintersection`` of every ray against every leaf sphere;
   it shares its predicate formulas with the kernels' plain versions, and
   ``tests/test_torch_rays.py`` holds it against the JAX package's
   ``isintersection`` on the CPU);
8. drives the ray fallback on the same scene (``row_cap=32,
   pair_cap=512``): launches of B4 and none of B2 and B3, the same hit set;
   then holds the ray variants against their plain versions at the
   full-width inputs;
9. runs tile self-contact at the 1M bench scene with ``decode_k=8`` (B2
   with moment words, the decode, B3): the contact set of phase 2;
10. runs a box-leaf scene (65,536 boxes, 8,192 rays), so that the
    ``ray_box`` mask runs on a path, on the card and on the CPU on both
    routes: identical hits, total, overflow and ``num_checks``; and
    ``traverse_rays`` with default arguments on the card (growth from the
    smallest capacity, dispatch to the tile engine) against the brute force;
11. holds the two-tree variants against their plain versions on a small
    two-body scene (4,096 and 2,048 leaves, tile 32, as spheres and as
    boxes): B1 with ``triangle=False`` and B2, B3, B4 with ``dedup=False``
    on two field sets, and ``compact_flat`` and B5 on the full grid, at the inputs both routes
    of ``traverse_tiles_pair_fixed`` give them; both routes must return
    the pairs of a brute force (``iscontact``);
12. drives the JAX package's own pair benchmark (config 4 of
    ``benchmarks/baseline_configs.py``: 32,768 and 16,384 triangles, seeds
    2 and 3, capacity 2^17) through ``traverse_tiles_pair_fixed`` on the
    two-phase route (default ``TileTraversal()``) and the fallback, launch
    counts set to 0 just before and read just after, and through
    ``traverse(bvh1, bvh2)`` with default arguments: overflow 0, no host
    sync, no duplicate pair, launches of B1, B2, B3 (two-phase) and B1, B5,
    B4 (fallback) and of no other, and the set of a brute force on the
    card over all 5.4 x 10^8 pairs;
13. drives the two-tree query at full width: the 1M bench BVH against a
    second body of 2^19 triangles (seed 3), capacity 2^17, pair capacity
    2^19, both routes, the same requirements; every pair must satisfy the
    sphere predicate and the set must equal the pairs that cross the two
    bodies in tile self-contact over both bodies' leaves together, and so
    must ``traverse(bvh1, bvh2)`` with default arguments (the wrapper's own
    capacities and growth); then holds each variant against its plain
    version at these inputs;
14. runs the leaf-vs-tree walks on the card through kernel W1 (two
    launches, the count and the write pass, no host sync):
    ``traverse(bvh1, bvh2, LVTTraversal())`` at config 4's scene (the tile
    engine's set); a sphere-leaf BVH against a box-leaf BVH with default
    arguments (mixed kinds take the walk; the brute force's set);
    ``traverse_rays(..., LVTTraversal())`` with 1,000 rays against the
    2^18-leaf ray BVH (the tile ray engine's hits); and 2,048 coincident
    spheres through ``traverse_tiles``, whose growth tries launch the tile
    kernels and end in W1 (every pair); each timed once with its launches,
    beside the parent's torch-op loop;
15. times (CUDA events, median of 7 after a warm-up) each self-contact
    route's 1M step end to end and by stage, the full-width ray query
    end to end and by stage (sort rays, phase 1, B2, regroup, decode, B3,
    the rest) and the full-width pair query on both routes end to end and
    by stage, each with its host enqueue time and a profile (device time
    by kernel, device busy share), and each kernel and variant at its
    full-size inputs beside its plain version and its kernels' own device
    time from the profiler; ``compact_flat`` and B5 also beside
    ``torch.masked_select`` on the same mask and payloads, at the path's
    capacity and like for like (capacity = the mask's length, where the
    lists equal ``masked_select``'s), with the old composition
    ``tile_compact`` + ``finish_compact`` in one call beside them; B2, B3
    and B4 also at the bench scene's inputs with ``nsteps`` set to 0 (the
    cost of the grid with no live step).
16. runs breadth-first traversal (torch ops, no kernel) on the card:
    ``traverse(bvh, BFSTraversal())`` at the bench scene (the two-phase
    route's set), ``traverse(bvh1, bvh2, BFSTraversal())`` at config 4's
    scene (the brute force's set) and at the full-width pair scene (phase
    13's set), and ``traverse_rays(..., BFSTraversal())`` at the full-width
    ray scene (the brute force's set); each wrapper timed (CUDA events,
    median of 7) with its growth tries and peak memory, and each
    ``bfs_*_fixed`` run once more at the wrapper's final capacity under the
    sync check: overflow 0, the same total and ``num_checks``;
17. runs depth-first self-contact through kernel W2 (two launches) on
    the ray scene's 2^18-leaf BVH against the tile engine's set and at the
    bench scene (phase 2's 57,868 contacts), each timed once;
18. builds the bench scene's spheres with ``ExtendedMortonAlgorithm``
    at 32 and 64 bits: the codes on the card must equal the port's CPU
    codes bit for bit and the leaves come out in the codes' unsigned
    order (a 64-bit code may set bit 63); prints the overflow bits and
    launches of one ``traverse_tiles_fixed`` two-phase call at phase 2's
    caps under the sync check, and requires ``traverse(bvh)`` with
    default arguments to return phase 2's set (with the wrapper's growth
    tries); times the build with both widths beside the default order;
19. runs ``BVHOptions(index_bits=64)``: the bench scene and the
    full-width ray scene on both routes and config 4's pair scene on both
    routes, each under the sync check with int64 contacts, the int32
    run's set and the int32 run's launches; BFS at config 4's first body
    (the int32 run's set) and at the bench scene (phase 2's set, with its
    peak memory); the 1M step's time beside int32's;
20. makes the 249,882-triangle reference scene of
    ``benchmarks/dragon_table.py`` (the same draws and casts: triangles
    from ``default_rng(0)``, 100,000 rays from ``default_rng(1)``) and
    runs ``traverse_tiles_fixed`` at capacity 2^15 on both routes and
    ``traverse_rays_tiles_fixed`` at capacity 2^18 on both routes under
    the sync check: overflow 0, no duplicates, 13,787 contacts equal to a
    brute force over all sphere pairs on the card and 196,130 hits equal
    to a brute force over all ray tests; then times the reference table's
    rows (bounding spheres, build, the contact step, the ray query on the
    prebuilt tree);
21. runs ``implicitbvh_tpu_torch.parallel`` (sharding) on a NCCL world of
    1 (a FileStore in ``build/``): ``sharded_rebuild_traverse_step`` on
    the bench spheres (57,868 contacts, phase 2's set, launches of B1-B3;
    again on moved geometry against ``traverse_tiles_fixed``), then
    ``sharded_tile_self_contact``, ``sharded_tile_pair`` (phase 13's
    57,568 pairs) and ``sharded_rays`` (198,988 hits) with launch counts,
    each under the sync check (the step's build included), the ray walk
    at phase 14's 1,000 rays and the self walk at phase 5's scene (W1's
    launches, under the sync check); the
    same sets as the disjoint union of 8 virtual ranks through
    the local functions, each rank under the sync check (or of the
    largest of 4 and 2 ranks at which no rank overflows), with each
    rank's count and live count steps; the scenes of the JAX package's
    multichip dry run (157 contacts, 32 hits, 319 pairs on the world of 1
    and on 8 ranks) and of its at-scale test (2^15 spheres, seed 33: no
    overflow, at least 4 ranks with contacts, ``traverse_tiles``' set);
    then times the sharded step beside the single-device one and the
    sharded ray query beside phase 7's (in turns), and each rank's local
    call at 8 ranks;
22. runs the sync-free step: ``implicitbvh_tpu_torch.entry``'s step
    (8,192 spheres), the bench step on both routes and the bench step
    built with the extended order at 32 and 64 bits, with fixed Morton
    bounds and with ``index_bits=64``, each under the sync check (phase
    2's set); then captures in CUDA graphs, each warmed up on a side
    stream first, the entry step, the bench step on both routes, the
    full-width pair query and ray query on both routes and the extended
    32-bit build, with the launch counts read after capture (each route's
    kernels) and the kernels of one replay read from the profiler; each
    graph is replayed on the captured inputs (57,868 contacts, 57,568
    pairs, 198,988 hits, the entry step a brute force's set, overflow 0)
    and on new ones copied into them (triangles of seed 4, the second
    body or the spheres moved by up to 0.05, rays of seed 6), each replay
    equal to the eager call on the same inputs; and times the eager call
    and the replay in turns, with each one's host time;
23. runs the walks on the device: W1 and W2 against their plain versions
    on small scenes of every variant (self with the dedup prune on box and
    sphere nodes and on box leaves, a start-level sweep, two trees both
    ways round, mixed leaf kinds, one-leaf trees, rays with zero and
    axis-aligned direction components on both leaf kinds and on sphere
    nodes, ``index_bits=64``, DFS at two start levels on each kind), each
    in float32 and in float64, and three walks of float64 lanes against
    float32 trees or the other way round; the counts, offsets and whole
    buffers exactly, a truncating capacity among them;
    ``traverse_lvt_single_fixed`` and DFS's count -> scan -> write at 2^18
    leaves, ``traverse_lvt_pair_fixed`` at config 4 and
    ``traverse_rays_fixed`` at 1,000 rays under the sync check, then
    captured as phase 22's cells and replayed on moved geometry and new
    rays; W1's and W2's count and write passes at phases 14 and 17's
    scenes, and W1's LVT self-contact at the bench scene (phase 2's set;
    the reference library's default algorithm), timed (CUDA events,
    median of 7, the profiler's device time) with the work's shape from
    the kernels' diagnostic variant (the longest lane, the longest item,
    the steps of all lanes, the SMs that ran one, the items), beside the
    plain loop's write pass once (not for DFS at 1M, where it would take
    minutes).
24. the tile engine in float64 (the kernels' ``<double>`` instantiation):
    each kernel (B1, B2 with its ray masks, moments and two field sets,
    B3, B4, B6) against its plain version on float64 inputs: the small
    scenes of phases 1, 6 and 11 and the bench, full-width ray and pair
    scenes' inputs; the bench scene built from its triangles in float64
    on both routes (its set the float64 W1 walk's), the 249,882-triangle
    reference scene against a float64 brute force over all sphere pairs,
    the full-width ray scene against ``brute_force_keys`` in float64,
    config 4's pair scene against ``brute_force_pair_keys`` and the
    full-width pair scene and a mixed pair (the float32 bench BVH against
    the float64 second body) against the float64 W1 walk, each on both
    routes with overflow 0, no duplicates and no host sync; a
    near-touching scene (500 pairs of spheres 2r(1 + 1e-10) apart: no
    contact in float64, the float32 brute force's contacts once rounded
    to float32) with B1-B4 launched; the float64 bench step and pair query
    captured as phase 22's cells and replayed on new inputs; and B1-B4 and
    B6 timed in float64 beside their float32 rows in turns, each with its
    bound (float64 operations over the H100's 34 TFLOP/s).
25. R1 (``ray_band_bits``, the ray query's phase 1) at the ``dragon-rays``
    cell's shape (100,000 rays against the 249,882-triangle scene's leaf
    tiles at tile 128: RT 782, T 1,953), in float32 and float64: kernel ==
    plain, its eager and device times, its bound (the slab tests times
    ``R1_INSTR_PER_TEST`` over the non-FMA issue rate, half the FLOP rate)
    and the plain version's time.  R1 is also held against its plain
    version wherever the ray kernels are (phases 6, 8 and 24), and phase 7
    requires one launch of it per ray query.
26. L1 (``ops.leader_group``, the tile engine's leader packing) at the
    inputs the paths give it at the three tile cells' shapes: the bench
    scene's self-contact at ``particles-1m``'s capacities, the bench BVH
    against a 249,882-triangle body at ``bed1m-tool250k``'s, and 100,000
    rays against the 249,882-triangle scene at capacity 524,288 (the ray
    regroup's 1,048,576 entries): each query's own count of
    ``launches.leader_group`` (two in the self and two-tree queries, one
    in the ray query; a row's ``launches`` is its query's count), then at
    each recorded input kernel == plain, with no host sync, its eager and
    device times beside its bytes bound (inputs read once, outputs
    written once), the plain chain's time and a lone ``torch.cummax`` of
    the same length (``library_ms``).  Every tile path of the phases
    before runs L1.
27. T1 (``ops.tree_build``, the build's kernels around one ``torch.sort``
    of int32 keys) at 2^20 and 249,882 sphere leaves: one launch a build,
    kernel == plain bit for bit (sorted leaves, indices, codes, nodes,
    skips) with no host sync, its eager time (the sort included), its four
    kernels' device time beside their bytes bound, the plain chain's time
    and a lone ``torch.sort`` of the chain's int64 keys (``library_ms``);
    then the three graph cells' step drivers (``portbench``) set up at
    their sizes, one warm-up, and every build of their warm-up and capture
    counted: ``launches.tree_build`` equals ``calls.build``.  Every build
    of the phases before on the card runs T1.

Each phase group prints its seconds and the script's total so far.
W1's and W2's rows (``walk_lanes[...]``, ``dfs_lanes[self]``) are their
write passes at phases 14, 17 and 23's scenes; their bounds count each
volume's own float32 fields read once (16 bytes a sphere, 24 a box or a
ray, not the packed records' padding), the index arrays, the counts and
the rows written, and the tests' operations; the work's shape (from the
kernels' diagnostic variant) stands beside them, with the count pass
unsplit (W1 in one stage, W2 in one round) and the steps of all lanes
spread over every thread of every SM at its time per step of the longest
lane.
The float64 rows (``<name>[f64]``) count their fields' 8-byte values and
their operations over the float64 rate.
Each row's bound is printed with both of its terms (bytes and operations)
and with the instruction floor of its operations (twice the operations
term: the predicates are explicitly rounded, so no operation fuses into an
FMA); B2 with ``moments`` counts as written only the word rows of live
pairs, the only rows it defines.  It prints one ``{"kernels": [...]}``
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises and exits non-zero; so does a machine
without a CUDA device.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_BENCH = 1 << 20          # triangles of the bench scene
N_CROSS = 1 << 16          # triangles of the card-vs-CPU scene
N_SMALL = 4096             # triangles of the small kernel-check scene
TPU_BENCH_CONTACTS = 57868  # the JAX package's total on this scene (TPU v5e)
TWO_PHASE = dict(row_cap=4, pair_cap=32)
FALLBACK = dict(row_cap=32, pair_cap=512)   # pair_cap > 128: the fallback

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
FP64_OPS_PER_S = 34e12      # H100 SXM, float64 outside the tensor cores
# sub/mul/add/compare per test (selects and the per-ray reciprocals and d.d
# not counted): ray_box 6 sub + 6 mul + 12 compares; ray_sphere 3 sub +
# 6 (qb) + 7 (qc) + 4 (disc) + 3 compares
FLOPS_PER_TEST = {"sphere": 11, "box": 6, "ray_box": 24, "ray_sphere": 23}
# R1's instructions per slab test (csrc/ray_band_bits.cu's note): the 24
# operations above, the 10 selects of the select min/max and the fold into
# the band flag
R1_INSTR_PER_TEST = 35

N_RAY_TRIS = 1 << 18       # triangles of the full-width ray scene
N_RAYS = 100_000           # its rays
RAY_CAPACITY = 1 << 18
TPU_RAY_HITS = 198988      # the JAX package's total on this scene (TPU v5e)
N_BOX_RAYS = 8192          # rays of the box-leaf scene (N_CROSS boxes)

N_PAIR4 = (1 << 15, 1 << 14)   # config 4 of benchmarks/baseline_configs.py
PAIR4_CAPACITY = 1 << 17
TPU_PAIR4_CONTACTS = 1882  # the JAX package's total on that scene (TPU v5e)
N_BODY2 = 1 << 19          # second body of the full-width pair scene
PAIR_CAPACITY = 1 << 17    # its contact capacity, both routes
PAIR_PAIR_CAPACITY = 1 << 19   # its tile-pair capacity, both routes
UNION_CAPACITY = 1 << 19   # self-contact over both bodies' leaves:
UNION_PAIR_CAPACITY = 1 << 20  # twice the density where they overlap
N_WALK_RAYS = 1000         # rays of the ray walk (config 3's walk point)
TPU_WALK_RAY_HITS = 1981   # the JAX package's total there (TPU v5e)
N_DENSE = 2048             # coincident spheres: past the slot caps' ceiling

# the 249,882-triangle reference scene (benchmarks/dragon_table.py)
N_DRAGON = 249_882
DRAGON_CAPACITY = 1 << 15      # dragon_table.py:78
DRAGON_RAY_CAPACITY = 1 << 18  # dragon_table.py:82
TPU_DRAGON_CONTACTS = 13787    # benchmarks/RESULTS.md:419,432 (TPU v5e)
TPU_DRAGON_HITS = 196130


def synth_triangles(n_tri: int, seed: int = 0):
    """Random triangle soup at about unit density, as (N, 3) float32 arrays
    (the bench scene's generator)."""
    rng = np.random.default_rng(seed)
    scale = float(n_tri) ** (1.0 / 3.0)
    c = (rng.random((n_tri, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    return c, c + e1, c + e2


def bench_rays(n_leaves: int, seed: int = 1):
    """The ray benchmark's 100,000 rays as (3, N) float32 arrays, the first
    draws of the generator, as ``benchmarks/profile_rays.py`` and
    ``diag_rays.py`` make them: the set behind the 198,988 hits of
    ``benchmarks/RESULTS.md``.  (Config 3 of
    ``benchmarks/baseline_configs.py`` draws them after a 1,000-ray set:
    other rays, another total.)"""
    rng = np.random.default_rng(seed)
    scale = float(n_leaves) ** (1.0 / 3.0)
    p = (rng.random((3, N_RAYS)) * scale).astype(np.float32)
    d = (rng.random((3, N_RAYS)) - 0.5).astype(np.float32)
    return p, d


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def profile_step(torch, run_step, step_ms, route, card, steps=3):
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

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        log(f"profile, {route}: the profiler recorded no device time "
            "(not measured)")
        return
    busy = sum(e.self_device_time_total for e in kern) / steps / 1e3
    log(f"profile, {route}: device busy {busy:.4f} ms per step, "
        f"{100 * busy / step_ms:.1f}% of the {step_ms:.4f} ms step, "
        f"{sum(e.count for e in kern) // steps} device ops per step [{card}]")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:16]:
        ms = e.self_device_time_total / steps / 1e3
        log(f"  {ms:9.4f} ms  x{e.count // steps:<4d} {e.key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import implicitbvh_tpu_torch as ib
    except ImportError as e:
        print(f"chip_smoke: run it from the repository's root ({e})",
              file=sys.stderr)
        return 2
    from implicitbvh_tpu_torch import ops, tracing
    from implicitbvh_tpu_torch.ops import _build
    from implicitbvh_tpu_torch.traverse import bfs, dfs, ray_tiles, tiles
    from implicitbvh_tpu_torch.traverse import walk as twalk

    t_script = time.perf_counter()
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
        "tile_group_contacts": (
            ops.tile_group_contacts, ops.tile_group_contacts_plain,
            "implicitbvh_tpu_torch/csrc/group_contacts.cu",
            "implicitbvh_tpu/ops/tile_contact.py:1286"),
        "tile_compact": (
            ops.tile_compact, ops.tile_compact_plain,
            "implicitbvh_tpu_torch/csrc/compact.cu",
            "implicitbvh_tpu/ops/compaction.py:106"),
        "tile_pair_contacts": (
            ops.tile_pair_contacts, ops.tile_pair_contacts_plain,
            "implicitbvh_tpu_torch/csrc/group_contacts.cu",
            "implicitbvh_tpu/ops/tile_contact.py:333"),
        # tile_compact and finish_compact (compaction.py:151) in one call
        "compact_flat": (
            ops.compact_flat, ops.compact_flat_plain,
            "implicitbvh_tpu_torch/csrc/compact.cu",
            "implicitbvh_tpu/ops/compaction.py:106"),
        # the port's kernels for the JAX package's two device loops
        # (lax.while_loop, no Pallas kernel): W1 and W2, whose plain
        # versions are the traverse layer's torch-op loops
        "walk_lanes": (
            ops.walk_lanes, twalk.walk_lanes_plain,
            "implicitbvh_tpu_torch/csrc/walk.cu",
            "implicitbvh_tpu/traverse/walk.py:140"),
        "dfs_lanes": (
            ops.dfs_lanes, dfs.dfs_lanes_plain,
            "implicitbvh_tpu_torch/csrc/dfs.cu",
            "implicitbvh_tpu/traverse/dfs.py:139"),
        # R1, the ray query's phase 1: the JAX package computes it in jnp
        # (no Pallas kernel), so it replaces none
        "ray_band_bits": (
            ops.ray_band_bits, ops.ray_band_bits_plain,
            "implicitbvh_tpu_torch/csrc/ray_band_bits.cu",
            "none: jnp in implicitbvh_tpu/traverse/ray_tiles.py:85"),
    }
    walk_kernels = ("walk_lanes", "dfs_lanes")
    # the kernels of self-contact's paths, each with a row at its inputs
    tile_kernels = [n for n in kernels
                    if n not in walk_kernels + ("ray_band_bits",)]
    # the CUDA kernels of each wrapper, by name in the profiler
    device_kernel = {"subtile_band_bits": ("band_bits_kernel",),
                     "tile_run_counts": ("run_counts_kernel",),
                     "tile_group_emit": ("emit_plan_kernel",
                                         "group_emit_kernel"),
                     "tile_group_contacts": ("slot_contacts_kernel",),
                     "tile_compact": ("compact_kernel",),
                     "tile_pair_contacts": ("slot_contacts_kernel",),
                     "compact_flat": ("compact_kernel",
                                      "compact_flat_kernel"),
                     # W1's stages and scan, W2's rounds, sums, places
                     # and write run: every kernel of each
                     "walk_lanes": ("walk_",),
                     "dfs_lanes": ("dfs_",),
                     "ray_band_bits": ("ray_band_bits_kernel",)}
    two_phase_kernels = ("subtile_band_bits", "tile_run_counts",
                         "tile_group_emit")
    fallback_kernels = ("subtile_band_bits", "compact_flat",
                        "tile_group_contacts")
    ray_two_phase_kernels = ("tile_run_counts", "tile_group_emit")
    ray_fallback_kernels = ("tile_group_contacts",)

    @contextlib.contextmanager
    def recorded_inputs():
        """Record the arguments each kernel wrapper gets from the path
        (the wrappers the engine's modules call by name: the tile back
        ends, R1, W1 and W2; B6 is on no path)."""
        seen = {}
        saved = [(module, name, getattr(module, name))
                 for module in (tiles, ray_tiles, twalk, dfs)
                 for name in kernels if hasattr(module, name)]

        def recorder(name, fn):
            def call(*args, **kw):
                seen[name] = (args, kw)
                return fn(*args, **kw)
            return call

        for module, name, fn in saved:
            setattr(module, name, recorder(name, fn))
        try:
            yield seen
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)

    def to_dev(tris, device):
        return tuple(tuple(torch.as_tensor(np.ascontiguousarray(p[:, k]),
                                           device=device) for k in range(3))
                     for p in tris)

    def step(p1, p2, p3, capacity, alg):
        spheres = ib.bsphere_from_triangles(p1, p2, p3)
        bvh = ib.build(spheres)
        return spheres, bvh, ib.traverse_tiles_fixed(bvh, capacity, alg=alg)

    def pair_list(bvh, alg):
        """B6's inputs: the fallback phase 1's packed pair list of ``bvh``
        at its pair capacity."""
        fields, sphere, tl, sub, T = tiles._tiled_fields(bvh, alg.tile,
                                                         alg.bands)
        packed, _, npairs = tiles._phase1_tile_pairs(
            tl, sub, tiles._pair_capacity_for(T))
        return ((packed, npairs.reshape(1), fields),
                dict(mask_kind="sphere" if sphere else "box",
                     ROW_CAP=alg.row_cap, CAP_PAIR=alg.pair_cap, dedup=True))

    def outputs_of(name, got, want, args, kw):
        """The tensors of a kernel's and its plain version's results that
        must be equal."""
        if name == "tile_run_counts" and kw.get("moments"):
            # the card writes only the word rows of live pairs
            live = ops.run_live_pairs(args[1], args[2], args[3],
                                      args[0].shape[0], args[-1].shape[1],
                                      R=kw["R"], NB=kw["NB"])
            return ([got[0], got[1], got[2][live]],
                    [want[0], want[1], want[2][live]])
        if name == "tile_group_emit":  # both streams in full, bit for bit
            return ([got[0], got[1], got[2].reshape(1), got[3].reshape(1)],
                    [want[0], want[1], want[2].reshape(1),
                     want[3].reshape(1)])
        if name == "compact_flat":
            return ([*got[0], got[1].reshape(1), got[2].reshape(1)],
                    [*want[0], want[1].reshape(1), want[2].reshape(1)])
        if name in ("tile_group_contacts", "tile_pair_contacts"):
            # counts and overflow, and every lane below a pair's count and
            # CAP_PAIR (-1 where a row over ROW_CAP left a gap)
            gi, gj, c, o = got
            pgi, pgj, pc, po = want
            C = kw["CAP_PAIR"]
            below = torch.arange(C, device=pc.device)[None, :] < \
                pc.clamp(max=C)[:, None]
            return ([c, o.reshape(1), gi[below], gj[below]],
                    [pc, po.reshape(1), pgi[below], pgj[below]])
        if name == "tile_compact":
            return ([*got[0], got[1], got[2].reshape(1)],
                    [*want[0], want[1], want[2].reshape(1)])
        return ([got] if torch.is_tensor(got) else list(got),
                [want] if torch.is_tensor(want) else list(want))

    errs = {}      # row of the kernels line -> max abs difference seen

    def is_f64(args):
        return any(torch.is_tensor(a) and a.dtype == torch.float64
                   for a in args)

    def row_of(name, kw, pair=False, f64=False):
        """The row of the kernels line a call belongs to: the kernel's name,
        with its variant where it is not the self-contact one (``pair``:
        the two-tree callers; ``cross`` for the kernels without a mask;
        ``f64``: the float64 instantiation)."""
        kind, moments = kw.get("mask_kind", ""), kw.get("moments", False)
        tags = [kind] * (kind.startswith("ray") or moments
                         or (pair and bool(kind))) + \
            ["moments"] * moments + \
            [("pair" if kind else "cross")] * pair + ["f64"] * f64
        return f"{name}[{','.join(tags)}]" if tags else name

    def check_kernel(name, args, kw, label, pair=False):
        wrapper, plain = kernels[name][:2]
        row = row_of(name, kw, pair, is_f64(args))
        errs.setdefault(row, 0)
        got, want = outputs_of(name, wrapper(*args, **kw),
                               plain(*args, **kw), args, kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(
                    f"{name} differs from its plain version ({label})")
            if g.numel():
                errs[row] = max(errs[row],
                                int((g.long() - w.long()).abs().max()))
        log(f"{label}: {row} kernel == plain (exact)")

    def compact_inputs(seen):
        """B5's inputs: ``compact_flat``'s at the path's call, without the
        capacity."""
        args, kw = seen["compact_flat"]
        return args, {k: v for k, v in kw.items() if k != "capacity"}

    def check_kernels(seen, label, names, pair=False):
        missing = set(names) - set(seen)
        if missing:
            raise AssertionError(f"{label}: {sorted(missing)} not called")
        for name in names:
            check_kernel(name, *seen[name], label, pair)
        if "compact_flat" in names:
            check_kernel("tile_compact", *compact_inputs(seen), label, pair)

    two_phase = ib.TileTraversal(**TWO_PHASE)
    fallback = ib.TileTraversal(**FALLBACK)

    # 1. kernels against their plain versions: small scene, tile 32
    small = to_dev(synth_triangles(N_SMALL, seed=1), dev)
    with recorded_inputs() as seen:
        step(*small, 4096, ib.TileTraversal(tile=32, **TWO_PHASE))
    check_kernels(seen, f"small scene ({N_SMALL} triangles, tile 32, "
                  "two-phase)", two_phase_kernels)
    small_fb = ib.TileTraversal(tile=32, row_cap=16, pair_cap=256)
    with recorded_inputs() as seen:
        _, small_bvh, _ = step(*small, 4096, small_fb)
    label = f"small scene ({N_SMALL} triangles, tile 32, fallback)"
    check_kernels(seen, label, fallback_kernels)
    check_kernel("tile_pair_contacts", *pair_list(small_bvh, small_fb),
                 label)

    def check_contacts(total, contacts, overflow, spheres, label):
        """Sorted (min, max) pairs inside the sphere predicate, no
        duplicates, no overflow; returns the sorted pair keys."""
        if overflow != 0:
            raise AssertionError(f"overflow {overflow} ({label})")
        c = contacts[:total].long() - 1
        if not bool((c[:, 0] < c[:, 1]).all()):
            raise AssertionError(f"contacts are not sorted (min, max) pairs "
                                 f"({label})")
        keys = (c[:, 0] * N_BENCH + c[:, 1]).sort().values
        if torch.unique(keys).numel() != total:
            raise AssertionError(f"duplicate contacts ({label})")
        xs, r = spheres.xs, spheres.r
        dx, dy, dz = (x[c[:, 0]] - x[c[:, 1]] for x in xs)
        rr = r[c[:, 0]] + r[c[:, 1]]
        if not bool((dx * dx + dy * dy + dz * dz <= rr * rr).all()):
            raise AssertionError(f"a contact fails the sphere predicate "
                                 f"({label})")
        return keys

    def launch_counts():
        return {name: ops.launch_count(k[0])
                for name, k in kernels.items()}

    def counted(fixed_call):
        """``fixed_call()`` with the launch counts set to 0 just before and
        read just after, under the sync check: a ``*_fixed`` tile path
        never syncs with the host."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fixed_call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, launch_counts()

    def main_path(bvh, alg):
        return counted(lambda: ib.traverse_tiles_fixed(bvh, capacity,
                                                       alg=alg))

    # 2. the two-phase route at the bench scene
    capacity = max(1 << (math.ceil(math.log2(N_BENCH)) - 3), 4096)
    tris = to_dev(synth_triangles(N_BENCH), dev)
    spheres = ib.bsphere_from_triangles(*tris)
    bvh = ib.build(spheres)
    (total, contacts, overflow, num_checks), launches_2p = \
        main_path(bvh, two_phase)
    total, ov = int(total), int(overflow)
    log(f"bench scene, two-phase: {N_BENCH} triangles, {total} contacts "
        f"(the JAX package reported {TPU_BENCH_CONTACTS} on a TPU v5e), "
        f"overflow {ov}, num_checks {float(num_checks):.0f}, "
        f"launches {launches_2p}")
    if min(launches_2p[n] for n in two_phase_kernels) < 1:
        raise AssertionError(f"a kernel was not launched: {launches_2p}")
    keys_2p = check_contacts(total, contacts, ov, spheres, "two-phase")
    log("bench scene, two-phase: every contact satisfies the sphere "
        "predicate, no duplicates, no host sync in traverse_tiles_fixed")

    # 3. the fallback on the same BVH
    (total_fb, contacts_fb, overflow_fb, num_checks_fb), launches_fb = \
        main_path(bvh, fallback)
    total_fb, ov_fb = int(total_fb), int(overflow_fb)
    log(f"bench scene, fallback {FALLBACK}: {total_fb} contacts, overflow "
        f"{ov_fb}, num_checks {float(num_checks_fb):.0f}, launches "
        f"{launches_fb}")
    if min(launches_fb[n] for n in fallback_kernels) < 1 or \
            launches_fb["tile_run_counts"] or launches_fb["tile_group_emit"] \
            or launches_fb["tile_compact"]:
        raise AssertionError(f"fallback launches are wrong: {launches_fb}")
    keys_fb = check_contacts(total_fb, contacts_fb, ov_fb, spheres,
                             "fallback")
    if total_fb != total or not torch.equal(keys_fb, keys_2p):
        raise AssertionError("the fallback's contacts differ from the "
                             "two-phase route's")
    log("bench scene, fallback: the contact set and total equal the "
        "two-phase route's; every contact satisfies the sphere predicate, "
        "no duplicates, no host sync in traverse_tiles_fixed")

    # 4. kernels against their plain versions at the bench scene's inputs
    with recorded_inputs() as seen_1m:
        step(*tris, capacity, two_phase)
    check_kernels(seen_1m, f"bench scene ({N_BENCH} triangles, two-phase)",
                  two_phase_kernels)
    with recorded_inputs() as seen_fb:
        step(*tris, capacity, fallback)
    label = f"bench scene ({N_BENCH} triangles, fallback)"
    check_kernels(seen_fb, label, fallback_kernels)
    b6_in = pair_list(bvh, fallback)
    check_kernel("tile_pair_contacts", *b6_in, label)
    inputs = {n: seen_1m[n] for n in two_phase_kernels}
    inputs.update({n: seen_fb[n] for n in ("compact_flat",
                                           "tile_group_contacts")})
    inputs["tile_compact"] = compact_inputs(seen_fb)
    inputs["tile_pair_contacts"] = b6_in

    # 5. both routes on the card against the port on the CPU; README demo
    cross = synth_triangles(N_CROSS, seed=2)
    cap_x = max(1 << (math.ceil(math.log2(N_CROSS)) - 3), 4096)
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        res = []
        for d in (dev, torch.device("cpu")):
            tot, con, ovx, nc = step(*to_dev(cross, d), cap_x, alg)[2]
            tot = int(tot)
            pairs = sorted(map(tuple, con[:tot].cpu().tolist()))
            res.append((tot, pairs, int(ovx), float(nc)))
        if res[0] != res[1] or res[0][2] != 0:
            raise AssertionError(f"card and CPU disagree on the {N_CROSS}-"
                                 f"triangle scene ({route})")
        log(f"cross scene, {route}: {N_CROSS} triangles, card == CPU: "
            f"{res[0][0]} contacts, overflow {res[0][2]}, num_checks "
            f"{res[0][3]:.0f}")
    ops.reset_launch_counts()
    demo = ib.traverse_tiles(ib.build(ib.BSphere(
        np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4]],
                 np.float32),
        np.array([0.5, 0.6, 0.5, 0.4, 0.6], np.float32), device=dev)))
    if demo.contacts_list() != [(1, 2), (2, 3), (4, 5)] or \
            ops.launch_count(ops.tile_group_contacts) < 1:
        raise AssertionError(f"README demo on the card: "
                             f"{demo.contacts_list()}")
    log(f"README demo on the card (default options, capacity "
        f"{demo.cache1.shape[0]}, fallback): {demo.contacts_list()}")

    # ---- batch ray queries ------------------------------------------------
    def ray_path(bvh, p, d, capacity, alg):
        return counted(lambda: ib.traverse_rays_tiles_fixed(
            bvh, p, d, capacity, alg=alg))

    def hit_keys(total, contacts, overflow, n_leaves, n_rays, label):
        """Sorted keys ``(leaf - 1) * n_rays + (ray - 1)`` of a ray result:
        no overflow, indices in range, no duplicate pair."""
        total, overflow = int(total), int(overflow)
        if overflow != 0:
            raise AssertionError(f"overflow {overflow} ({label})")
        c = contacts[:total].long() - 1
        if total and not bool(((c >= 0).all(1) & (c[:, 0] < n_leaves)
                               & (c[:, 1] < n_rays)).all()):
            raise AssertionError(f"a hit's indices are out of range ({label})")
        keys = (c[:, 0] * n_rays + c[:, 1]).sort().values
        if torch.unique(keys).numel() != total:
            raise AssertionError(f"duplicate (leaf, ray) pairs ({label})")
        return keys

    def brute_force_keys(vol, p, d, chunk=256):
        """The same keys from ``isintersection`` of every ray against every
        leaf of ``vol`` (user order), ``chunk`` rays at a time."""
        n_rays = p.shape[1]
        if isinstance(vol, ib.BSphere):
            v = ib.BSphere(tuple(x[:, None] for x in vol.xs), vol.r[:, None])
        else:
            v = ib.BBox(tuple(x[:, None] for x in vol.los),
                        tuple(x[:, None] for x in vol.ups))
        keys = []
        for k0 in range(0, n_rays, chunk):
            hit = ib.isintersection(
                v, tuple(p[c, None, k0:k0 + chunk] for c in range(3)),
                tuple(d[c, None, k0:k0 + chunk] for c in range(3)))
            leaf, ray = hit.nonzero(as_tuple=True)
            keys.append(leaf * n_rays + ray + k0)
        return torch.cat(keys).sort().values

    def ray_pair_list(args):
        """B6's ray inputs: the live entries of a grouped ray list as a
        packed ``ti << 16 | tj`` pair list."""
        a_idx, b_idx, nsteps, rf, lf = args
        W = b_idx.shape[0] // a_idx.shape[0]
        e = torch.arange(b_idx.shape[0], device=dev)
        live = ((e // W) < nsteps) & ((b_idx >> 16) != 0)
        packed = ((a_idx[e // W] << 16) | (b_idx & 0xFFFF))[live]
        n = torch.tensor([packed.shape[0]], dtype=torch.int32, device=dev)
        return packed.int().contiguous(), n, rf, lf

    def record_ray_inputs(bvh, p, d, capacity, two_phase_alg, fallback_alg,
                          emit_alg=None):
        """The ray kernels' inputs on one scene: B2 (and B3) from the
        two-phase route, B3 from ``emit_alg`` when given (without the
        decode every pair with hits reaches it), B4 from the fallback."""
        with recorded_inputs() as seen:
            ib.traverse_rays_tiles_fixed(bvh, p, d, capacity,
                                         alg=two_phase_alg)
        if emit_alg is not None:
            with recorded_inputs() as seen_e:
                ib.traverse_rays_tiles_fixed(bvh, p, d, capacity,
                                             alg=emit_alg)
            seen["tile_group_emit"] = seen_e["tile_group_emit"]
        with recorded_inputs() as seen_f:
            ib.traverse_rays_tiles_fixed(bvh, p, d, capacity,
                                         alg=fallback_alg)
        seen.update(seen_f)
        return seen

    def check_ray_kernels(seen, label):
        check_kernels(seen, label, ray_two_phase_kernels +
                      ray_fallback_kernels + ("ray_band_bits",))
        args, kw = seen["tile_group_contacts"]
        check_kernel("tile_pair_contacts", ray_pair_list(args), kw, label)

    # 6. ray variants against their plain versions: small scene, tile 32
    rng = np.random.default_rng(3)
    small_spheres = ib.bsphere_from_triangles(*small)
    span = float(N_SMALL) ** (1.0 / 3.0)
    sp = (rng.random((3, 1024)) * span).astype(np.float32)
    sd = (rng.random((3, 1024)) - 0.5).astype(np.float32)
    sd[0, :64] = 0.0                       # zero direction components
    sd[1, 32:96] = 0.0
    sp[:, :160] = np.round(sp[:, :160])         # origins on lattice planes
    sd[:, 160:224] = np.sign(sd[:, 160:224])    # equal |d|: bin ties
    sp, sd = torch.as_tensor(sp, device=dev), torch.as_tensor(sd, device=dev)
    small_boxes = ib.BBox(
        tuple(torch.round(x - small_spheres.r) for x in small_spheres.xs),
        tuple(torch.round(x + small_spheres.r) + 0.5
              for x in small_spheres.xs))   # faces on the rays' planes
    ray_small = dict(tile=32, row_cap=16, pair_cap=128)
    for kind, vol in (("sphere", small_spheres), ("box", small_boxes)):
        seen = record_ray_inputs(
            ib.build(vol), sp, sd, 1 << 15,
            ib.TileTraversal(decode_k=8, **ray_small),
            ib.TileTraversal(tile=32, row_cap=16, pair_cap=256),
            emit_alg=ib.TileTraversal(**ray_small))
        check_ray_kernels(seen, f"small ray scene ({N_SMALL} {kind} leaves, "
                          "1024 rays, tile 32)")
    with recorded_inputs() as seen:
        ib.traverse_tiles_fixed(small_bvh, 4096, alg=ib.TileTraversal(
            tile=32, decode_k=8, **TWO_PHASE))
    check_kernels(seen, f"small scene ({N_SMALL} triangles, tile 32, "
                  "two-phase with decode_k=8)", ("tile_run_counts",))

    # 7. the ray query at full width, two-phase route with the ray defaults
    ray_spheres = ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_RAY_TRIS), dev))
    ray_bvh = ib.build(ray_spheres)
    rp, rd = (torch.as_tensor(x, device=dev) for x in bench_rays(N_RAY_TRIS))
    ray_fallback = ib.TileTraversal(row_cap=32, pair_cap=512)
    (r_total, r_contacts, r_overflow, r_checks), launches_ray = \
        ray_path(ray_bvh, rp, rd, RAY_CAPACITY, None)
    log(f"ray scene, two-phase: {N_RAY_TRIS} leaves, {N_RAYS} rays, "
        f"{int(r_total)} hits (the JAX package reported {TPU_RAY_HITS} on a "
        f"TPU v5e), overflow {int(r_overflow)}, num_checks "
        f"{float(r_checks):.0f}, launches {launches_ray}")
    if min(launches_ray[n] for n in ray_two_phase_kernels) < 1 or \
            launches_ray["tile_group_contacts"] or \
            launches_ray["ray_band_bits"] != 1:
        raise AssertionError(f"ray launches are wrong: {launches_ray}")
    keys_ray = hit_keys(r_total, r_contacts, r_overflow, N_RAY_TRIS, N_RAYS,
                        "ray two-phase")
    t0 = time.perf_counter()
    keys_bf = brute_force_keys(ray_spheres, rp, rd)
    log(f"ray scene: brute force of {N_RAYS} x {N_RAY_TRIS} tests on the "
        f"card, {keys_bf.numel()} hits, {time.perf_counter() - t0:.3f} s")
    if not torch.equal(keys_ray, keys_bf):
        raise AssertionError("the ray query's hit set differs from the "
                             "brute force's")
    log("ray scene, two-phase: the hit set equals the brute force's, no "
        "duplicates, no host sync in traverse_rays_tiles_fixed")

    # 8. the ray fallback on the same scene; kernels at the full-width inputs
    (f_total, f_contacts, f_overflow, f_checks), launches_rayfb = \
        ray_path(ray_bvh, rp, rd, RAY_CAPACITY, ray_fallback)
    log(f"ray scene, fallback {FALLBACK}: {int(f_total)} hits, overflow "
        f"{int(f_overflow)}, num_checks {float(f_checks):.0f}, launches "
        f"{launches_rayfb}")
    if launches_rayfb["tile_group_contacts"] < 1 or \
            launches_rayfb["tile_run_counts"] or \
            launches_rayfb["tile_group_emit"]:
        raise AssertionError(f"ray fallback launches are wrong: "
                             f"{launches_rayfb}")
    if not torch.equal(hit_keys(f_total, f_contacts, f_overflow, N_RAY_TRIS,
                                N_RAYS, "ray fallback"), keys_bf):
        raise AssertionError("the ray fallback's hit set differs from the "
                             "brute force's")
    log("ray scene, fallback: the hit set equals the brute force's, no "
        "duplicates, no host sync in traverse_rays_tiles_fixed")
    del r_contacts, f_contacts
    seen_ray = record_ray_inputs(ray_bvh, rp, rd, RAY_CAPACITY, None,
                                 ray_fallback)
    check_ray_kernels(seen_ray, f"ray scene ({N_RAY_TRIS} leaves, {N_RAYS} "
                      "rays)")

    # 9. self-contact at the bench scene through the moment decode
    decode = ib.TileTraversal(decode_k=8, **TWO_PHASE)
    (d_total, d_contacts, d_overflow, _), launches_dec = \
        main_path(bvh, decode)
    keys_dec = check_contacts(int(d_total), d_contacts, int(d_overflow),
                              spheres, "two-phase with decode_k=8")
    if int(d_total) != total or not torch.equal(keys_dec, keys_2p):
        raise AssertionError("decode_k=8 changes the contact set")
    log(f"bench scene, two-phase with decode_k=8: {int(d_total)} contacts, "
        f"the decode_k=0 set; launches {launches_dec}")
    with recorded_inputs() as seen_dec:
        ib.traverse_tiles_fixed(bvh, capacity, alg=decode)
    check_kernels(seen_dec, f"bench scene ({N_BENCH} triangles, two-phase "
                  "with decode_k=8)", ("tile_run_counts",))

    # 10. box leaves, card against CPU on both routes; traverse_rays
    cs = ib.bsphere_from_triangles(*to_dev(cross, torch.device("cpu")))
    box_lo = torch.stack([x - cs.r for x in cs.xs], 1).numpy()
    box_up = torch.stack([x + cs.r for x in cs.xs], 1).numpy()
    brng = np.random.default_rng(4)
    bscale = float(N_CROSS) ** (1.0 / 3.0)
    bp = (brng.random((3, N_BOX_RAYS)) * bscale).astype(np.float32)
    bd = (brng.random((3, N_BOX_RAYS)) - 0.5).astype(np.float32)
    bd[2, :256] = 0.0
    cap_b = 1 << 16
    box_algs = (("two-phase", ib.TileTraversal(row_cap=8, pair_cap=64,
                                               emit_w=8, decode_k=8)),
                ("fallback", ray_fallback))
    launches_box = {}
    for route, alg in box_algs:
        res = []
        for dv in (dev, torch.device("cpu")):
            bb = ib.build(ib.BBox(box_lo, box_up, device=dv))
            ops.reset_launch_counts()
            tot, con, ovx, nc = ib.traverse_rays_tiles_fixed(
                bb, torch.as_tensor(bp, device=dv),
                torch.as_tensor(bd, device=dv), cap_b, alg=alg)
            if dv == dev:
                launches_box[route] = launch_counts()
                box_bvh = bb
            tot = int(tot)
            res.append((tot, sorted(map(tuple, con[:tot].cpu().tolist())),
                        int(ovx), float(nc)))
        if res[0] != res[1] or res[0][2] != 0 or res[0][0] == 0:
            raise AssertionError(f"card and CPU disagree on the box-leaf "
                                 f"ray scene ({route})")
        log(f"box-leaf ray scene, {route}: {N_CROSS} boxes, {N_BOX_RAYS} "
            f"rays, card == CPU: {res[0][0]} hits, overflow {res[0][2]}, "
            f"num_checks {res[0][3]:.0f}, launches {launches_box[route]}")
    bpd, bdd = torch.as_tensor(bp, device=dev), torch.as_tensor(bd, device=dev)
    seen_box = record_ray_inputs(box_bvh, bpd, bdd, cap_b, box_algs[0][1],
                                 ray_fallback)
    check_ray_kernels(seen_box, f"box-leaf ray scene ({N_CROSS} boxes, "
                      f"{N_BOX_RAYS} rays)")
    for nr in (64, 1024):     # capacity 256 (fallback), 4096 (two-phase)
        ops.reset_launch_counts()
        t = ib.traverse_rays(ib.build(small_spheres), sp[:, :nr].cpu().numpy(),
                             sd[:, :nr].cpu().numpy())
        got = hit_keys(t.num_contacts, t.cache1, 0, N_SMALL, nr,
                       "traverse_rays")
        if not torch.equal(got, brute_force_keys(
                small_spheres, sp[:, :nr].contiguous(),
                sd[:, :nr].contiguous())) or t.cache1.device.type != "cuda":
            raise AssertionError("traverse_rays differs from the brute force")
        log(f"traverse_rays with default arguments on the card: {N_SMALL} "
            f"leaves, {nr} rays, {t.num_contacts} hits, capacity "
            f"{t.cache1.shape[0]}, {t.tile_alg}, launches {launch_counts()}")

    # ---- two-tree contact, the public traverse, the walks -----------------

    def pair_path(b1, b2, cap, alg, pair_capacity=None):
        return counted(lambda: ib.traverse_tiles_pair_fixed(
            b1, b2, cap, alg=alg, pair_capacity=pair_capacity))

    def pair_keys(total, contacts, overflow, n1, n2, label):
        """Sorted keys ``(i - 1) * n2 + (j - 1)`` of a two-tree result: no
        overflow, indices in range, no duplicate pair."""
        total, overflow = int(total), int(overflow)
        if overflow != 0:
            raise AssertionError(f"overflow {overflow} ({label})")
        c = contacts[:total].long() - 1
        if total and not bool(((c >= 0).all(1) & (c[:, 0] < n1)
                               & (c[:, 1] < n2)).all()):
            raise AssertionError(f"a pair's indices are out of range "
                                 f"({label})")
        keys = (c[:, 0] * n2 + c[:, 1]).sort().values
        if torch.unique(keys).numel() != total:
            raise AssertionError(f"duplicate pairs ({label})")
        return keys

    def brute_force_pair_keys(v1, v2, tests=1 << 25):
        """The same keys from ``iscontact`` of every leaf of ``v1`` against
        every leaf of ``v2`` (user order), ``tests`` pairs at a time."""
        n1, n2 = v1.batch_shape[0], v2.batch_shape[0]
        rows = max(1, tests // n2)
        keys = []
        for k0 in range(0, n1, rows):
            a = v1[k0:k0 + rows]
            if isinstance(a, ib.BSphere):
                a = ib.BSphere(tuple(x[:, None] for x in a.xs), a.r[:, None])
            else:
                a = ib.BBox(tuple(x[:, None] for x in a.los),
                            tuple(x[:, None] for x in a.ups))
            i, j = ib.iscontact(a, v2).nonzero(as_tuple=True)
            keys.append((i + k0) * n2 + j)
        return torch.cat(keys).sort().values

    def check_pair_launches(launches, route, label):
        want, none = ((two_phase_kernels, ("tile_group_contacts",
                                           "compact_flat", "tile_compact"))
                      if route == "two-phase" else
                      (fallback_kernels, ("tile_run_counts",
                                          "tile_group_emit", "tile_compact")))
        if min(launches[n] for n in want) < 1 or \
                any(launches[n] for n in none):
            raise AssertionError(f"{label}: launches are wrong: {launches}")

    def boxes_of(sph):
        return ib.BBox(tuple(x - sph.r for x in sph.xs),
                       tuple(x + sph.r for x in sph.xs))

    # 11. two-tree kernel variants against their plain versions: tile 32
    small2_spheres = ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_SMALL // 2, seed=2), dev))
    pair_small_2p = ib.TileTraversal(tile=32, **TWO_PHASE)
    for kind, v1, v2 in (("sphere", small_spheres, small2_spheres),
                         ("box", boxes_of(small_spheres),
                          boxes_of(small2_spheres))):
        b1, b2 = ib.build(v1), ib.build(v2)
        label = (f"small pair scene ({N_SMALL} x {N_SMALL // 2} {kind} "
                 "leaves, tile 32")
        with recorded_inputs() as seen:
            out_2p = ib.traverse_tiles_pair_fixed(b1, b2, 8192,
                                                  alg=pair_small_2p)
        check_kernels(seen, label + ", two-phase)", two_phase_kernels,
                      pair=True)
        if seen["subtile_band_bits"][1]["triangle"] or \
                seen["tile_run_counts"][1]["dedup"] or \
                len(seen["tile_group_emit"][0]) != 5:
            raise AssertionError("the pair path did not take triangle=False, "
                                 "dedup=False and two field sets")
        with recorded_inputs() as seen:
            out_fb = ib.traverse_tiles_pair_fixed(b1, b2, 8192, alg=small_fb)
        check_kernels(seen, label + ", fallback)", fallback_kernels,
                      pair=True)
        bf = brute_force_pair_keys(v1, v2)
        for route, out in (("two-phase", out_2p), ("fallback", out_fb)):
            if not torch.equal(pair_keys(*out[:3], N_SMALL, N_SMALL // 2,
                                         f"{label}, {route})"), bf):
                raise AssertionError(f"{label}, {route}): the pair set "
                                     "differs from the brute force's")
        log(f"{label}): both routes return the brute force's "
            f"{bf.numel()} pairs")

    # 12. the JAX package's pair benchmark (config 4 of
    # benchmarks/baseline_configs.py): both routes and traverse(bvh1, bvh2)
    c4 = [ib.bsphere_from_triangles(*to_dev(synth_triangles(n, seed=sd), dev))
          for n, sd in ((N_PAIR4[0], 2), (N_PAIR4[1], 3))]
    c4_bvh = [ib.build(v) for v in c4]
    t0 = time.perf_counter()
    keys_c4 = brute_force_pair_keys(*c4)
    log(f"config 4 scene: brute force of {N_PAIR4[0]} x {N_PAIR4[1]} tests "
        f"on the card, {keys_c4.numel()} pairs (the JAX package reported "
        f"{TPU_PAIR4_CONTACTS} on a TPU v5e), "
        f"{time.perf_counter() - t0:.3f} s")
    launches_c4_of = {}
    for route, alg in (("two-phase", None), ("fallback", fallback)):
        (p_total, p_contacts, p_overflow, p_checks), launches_c4 = \
            pair_path(*c4_bvh, PAIR4_CAPACITY, alg)
        launches_c4_of[route] = launches_c4
        label = f"config 4 scene, {route}"
        log(f"{label}: {int(p_total)} contacts, overflow {int(p_overflow)}, "
            f"num_checks {float(p_checks):.0f}, launches {launches_c4}")
        check_pair_launches(launches_c4, route, label)
        if not torch.equal(pair_keys(p_total, p_contacts, p_overflow,
                                     *N_PAIR4, label), keys_c4):
            raise AssertionError(f"{label}: the pair set differs from the "
                                 "brute force's")
        log(f"{label}: the pair set equals the brute force's, no "
            "duplicates, no host sync in traverse_tiles_pair_fixed")
    ops.reset_launch_counts()
    t = ib.traverse(*c4_bvh)
    if t.tile_alg is None or t.cache1.device.type != "cuda" or \
            not torch.equal(pair_keys(t.num_contacts, t.cache1, 0, *N_PAIR4,
                                      "traverse(bvh1, bvh2)"), keys_c4):
        raise AssertionError("traverse(bvh1, bvh2) with default arguments "
                             "differs from the brute force")
    log(f"traverse(bvh1, bvh2) with default arguments on the card: "
        f"{t.num_contacts} contacts, capacity {t.cache1.shape[0]}, pair "
        f"capacity {t.pair_capacity}, {t.tile_alg}, launches "
        f"{launch_counts()}")

    # 13. the two-tree query at full width: the bench BVH against a second
    # body, both routes, against tile self-contact over both leaf sets
    body2 = ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_BODY2, seed=3), dev))
    bvh2 = ib.build(body2)
    pair_runs = {}
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        (p_total, p_contacts, p_overflow, p_checks), launches_p = \
            pair_path(bvh, bvh2, PAIR_CAPACITY, alg, PAIR_PAIR_CAPACITY)
        label = f"pair scene, {route}"
        log(f"{label}: {N_BENCH} x {N_BODY2} leaves, capacity "
            f"{PAIR_CAPACITY}, pair capacity {PAIR_PAIR_CAPACITY}: "
            f"{int(p_total)} contacts, overflow {int(p_overflow)}, "
            f"num_checks {float(p_checks):.0f}, launches {launches_p}")
        check_pair_launches(launches_p, route, label)
        keys = pair_keys(p_total, p_contacts, p_overflow, N_BENCH, N_BODY2,
                         label)
        c = p_contacts[:int(p_total)].long() - 1
        if not bool(ib.iscontact(spheres[c[:, 0]], body2[c[:, 1]]).all()):
            raise AssertionError(f"{label}: a pair fails the sphere "
                                 "predicate")
        pair_runs[route] = (keys, launches_p)
    del p_contacts
    both = ib.BSphere(tuple(torch.cat([a, b]) for a, b in
                            zip(spheres.xs, body2.xs)),
                      torch.cat([spheres.r, body2.r]))
    u_total, u_contacts, u_overflow, _ = ib.traverse_tiles_fixed(
        ib.build(both), UNION_CAPACITY, alg=two_phase,
        pair_capacity=UNION_PAIR_CAPACITY)
    if int(u_overflow) != 0:
        raise AssertionError(f"self-contact over both bodies overflows: "
                             f"{int(u_overflow)}")
    u = u_contacts[:int(u_total)].long() - 1       # sorted (min, max)
    cross_pairs = u[(u[:, 0] < N_BENCH) & (u[:, 1] >= N_BENCH)]
    keys_union = (cross_pairs[:, 0] * N_BODY2
                  + (cross_pairs[:, 1] - N_BENCH)).sort().values
    for route, (keys, _) in pair_runs.items():
        if not torch.equal(keys, keys_union):
            raise AssertionError(f"pair scene, {route}: the pair set differs "
                                 "from self-contact over both leaf sets")
    log(f"pair scene: both routes return the {keys_union.numel()} pairs that "
        f"cross the two bodies among the {int(u_total)} self-contacts of "
        f"their {N_BENCH + N_BODY2} leaves together; every pair satisfies "
        "the sphere predicate, no duplicates, no host sync in "
        "traverse_tiles_pair_fixed")
    del u_contacts, u, both
    t = ib.traverse(bvh, bvh2)     # the wrapper's own capacities, and growth
    if t.tile_alg is None or not torch.equal(
            pair_keys(t.num_contacts, t.cache1, 0, N_BENCH, N_BODY2,
                      "traverse(bvh1, bvh2) at full width"), keys_union):
        raise AssertionError("traverse(bvh1, bvh2) at full width differs "
                             "from self-contact over both leaf sets")
    log(f"pair scene, traverse(bvh1, bvh2) with default arguments: "
        f"{t.num_contacts} contacts, capacity {t.cache1.shape[0]}, pair "
        f"capacity {t.pair_capacity} (it starts from "
        f"{tiles._pair_capacity_for((N_BENCH + N_BODY2) // 256)}), "
        f"{t.tile_alg}")
    del t
    with recorded_inputs() as seen_pair:
        ib.traverse_tiles_pair_fixed(bvh, bvh2, PAIR_CAPACITY, alg=two_phase,
                                     pair_capacity=PAIR_PAIR_CAPACITY)
    check_kernels(seen_pair, f"pair scene ({N_BENCH} x {N_BODY2} leaves, "
                  "two-phase)", two_phase_kernels, pair=True)
    with recorded_inputs() as seen_pair_fb:
        ib.traverse_tiles_pair_fixed(bvh, bvh2, PAIR_CAPACITY, alg=fallback,
                                     pair_capacity=PAIR_PAIR_CAPACITY)
    check_kernels(seen_pair_fb, f"pair scene ({N_BENCH} x {N_BODY2} leaves, "
                  "fallback)", fallback_kernels, pair=True)

    # 14. the leaf-vs-tree walks on the card: kernel W1 (few lanes split by
    # subtree), no host sync; the parent's torch-op loop synced once every
    # 32 steps
    walk_seen = {}     # row of the kernels line -> (W1's write-pass call,
                       # the launches of its run)

    def walked(label, row, call, parent_s):
        """``call()`` timed once on the host's clock to the device's end,
        the launches counted from 0 and W1's inputs recorded (its last
        call: the write pass)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with recorded_inputs() as seen:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        log(f"time: walk (W1), {label}: {ms:.3f} ms once, "
            f"{out.num_contacts} contacts, launches "
            f"{ {n: v for n, v in launches.items() if v} } (the parent's "
            f"torch-op loop, one host sync per 32 steps: {parent_s} s on an "
            f"H100 80GB HBM3, PERF.md section 5) [{card}]")
        if launches["walk_lanes"] != 2 or out.tile_alg is not None:
            raise AssertionError(f"{label}: W1 did not run its two passes")
        walk_seen[row] = (seen["walk_lanes"], launches["walk_lanes"])
        return out, launches

    t, _ = walked(f"traverse(bvh1, bvh2, LVTTraversal()), {N_PAIR4[0]} x "
                  f"{N_PAIR4[1]} leaves", "walk_lanes[pair]",
                  lambda: ib.traverse(*c4_bvh, ib.LVTTraversal()),
                  "0.52-0.88")
    if not torch.equal(pair_keys(t.num_contacts, t.cache1, 0, *N_PAIR4,
                                 "LVT pair walk"), keys_c4):
        raise AssertionError("the LVT pair walk differs from the tile engine")
    mixed = (ib.build(small_spheres), ib.build(boxes_of(small2_spheres)))
    t, _ = walked(f"traverse(sphere-leaf BVH, box-leaf BVH), default "
                  f"arguments, {N_SMALL} x {N_SMALL // 2} leaves",
                  "walk_lanes[mixed]", lambda: ib.traverse(*mixed),
                  "0.25-0.52")
    if not torch.equal(
            pair_keys(t.num_contacts, t.cache1, 0, N_SMALL, N_SMALL // 2,
                      "mixed leaf kinds"),
            brute_force_pair_keys(small_spheres, boxes_of(small2_spheres))):
        raise AssertionError("mixed leaf kinds: the walk differs from the "
                             "brute force")
    wrng = np.random.default_rng(1)     # config 3 draws its walk's rays last
    wscale = float(N_RAY_TRIS) ** (1.0 / 3.0)
    for nr in (1000, N_RAYS, N_WALK_RAYS):
        wp = (wrng.random((3, nr)) * wscale).astype(np.float32)
        wd = (wrng.random((3, nr)) - 0.5).astype(np.float32)
    wp, wd = torch.as_tensor(wp, device=dev), torch.as_tensor(wd, device=dev)
    t, _ = walked(f"traverse_rays(LVTTraversal()), {N_WALK_RAYS} rays x "
                  f"{N_RAY_TRIS} leaves", "walk_lanes[ray_sphere]",
                  lambda: ib.traverse_rays(ray_bvh, wp, wd,
                                           ib.LVTTraversal()), "7.2-10.6")
    tile_hits = ib.traverse_rays(ray_bvh, wp, wd)
    if tile_hits.tile_alg is None or not torch.equal(
            hit_keys(t.num_contacts, t.cache1, 0, N_RAY_TRIS, N_WALK_RAYS,
                     "ray walk"),
            hit_keys(tile_hits.num_contacts, tile_hits.cache1, 0, N_RAY_TRIS,
                     N_WALK_RAYS, "tile ray engine")):
        raise AssertionError("the ray walk differs from the tile ray engine")
    log(f"ray walk: the tile ray engine's {tile_hits.num_contacts} hits "
        f"(the JAX package reported {TPU_WALK_RAY_HITS} on a TPU v5e)")
    dense = ib.build(ib.BSphere(
        torch.zeros((N_DENSE, 3), device=dev),
        torch.full((N_DENSE,), 0.5, device=dev)))
    t, dense_launches = walked(
        f"traverse_tiles past the slot caps' ceilings, {N_DENSE} coincident "
        "spheres (eight tile runs, then the walk)", "walk_lanes[self]",
        lambda: ib.traverse_tiles(dense), "10.0-14.5")
    if dense_launches["subtile_band_bits"] < 1:
        raise AssertionError(f"the dense scene's growth tries did not launch "
                             f"the tile kernels: {dense_launches}")
    c = t.contacts.long()
    if t.num_contacts != N_DENSE * (N_DENSE - 1) // 2 or \
            not bool((c[:, 0] < c[:, 1]).all()) or \
            torch.unique(c[:, 0] * (N_DENSE + 1) + c[:, 1]).numel() != \
            t.num_contacts:
        raise AssertionError("the dense scene's contacts are not every pair")
    log(f"dense scene: the growth tries launched the tile kernels, then "
        f"growth ended in W1, which returns all {t.num_contacts} pairs")
    del t, c

    # 15. timings at the bench scene, the full-width ray scene and the
    # full-width pair scene
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

    def span_ms(query, stages):
        """One query with tracing on: each stage's device time from the
        spans it opened, ``stages`` a tuple of (label, span name); a label
        given several names sums their spans, a name given several labels
        deals its spans to them in turn.  "the rest" is the query's time
        less the stages'."""
        takers, t, dealt = {}, {}, {}
        for label, name in stages:
            takers.setdefault(name, []).append(label)
            t[label] = 0.0
        with tracing.enabled(), tracing.span("smoke.query", dev) as whole:
            query()
        for sp in tracing.snapshot()["spans"]:
            if sp["id"] == whole.id:
                t["the rest"] = sp["device_ms"] - sum(t.values())
            elif sp["parent"] == whole.id and sp["name"] in takers:
                labels = takers[sp["name"]]
                k = dealt.get(sp["name"], 0)
                dealt[sp["name"]] = k + 1
                t[labels[k % len(labels)]] += sp["device_ms"]
        return t

    def host_ms(query):
        """Median host time to enqueue one query, of 7."""
        host = []
        for _ in range(7):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            query()
            host.append((time.perf_counter() - h0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(host)

    tile_spans = ("tiles.fields", "tiles.phase1", "tiles.count",
                  "tiles.regroup", "tiles.emit", "tiles.merge",
                  "tiles.finish")
    step_stages = (("bounding spheres", "spheres"), ("build", "build")) + \
        tuple(("traversal", name) for name in tile_spans)

    def time_route(route, alg):
        """The route's step end to end and by stage, its host enqueue time
        and its profile."""
        step_ms = time_ms(lambda: step(*tris, capacity, alg))
        log(f"time: bench step end to end, {route}: {step_ms:.4f} ms "
            f"[{card}]")
        stages = [span_ms(lambda: step(*tris, capacity, alg), step_stages)
                  for _ in range(7)]
        log(f"time: stages, {route} (median of 7) "
            + ", ".join(f"{n} {statistics.median(t[n] for t in stages):.4f}"
                        f" ms" for n in ("bounding spheres", "build",
                                         "traversal"))
            + f" [{card}]")
        log(f"time: host enqueue of one step, {route}: "
            f"{host_ms(lambda: step(*tris, capacity, alg)):.4f} ms "
            f"(median of 7) [{card}]")
        profile_step(torch, lambda: step(*tris, capacity, alg), step_ms,
                     route, card)

    time_route("two-phase", two_phase)
    time_route("fallback", fallback)

    # the first rays.phase1 span tiles the leaves and rays, the second is R1
    # and the run lists; rays.emit holds the decode and B3
    ray_stages = (("sort rays", "rays.sort"), ("tile", "rays.phase1"),
                  ("phase 1", "rays.phase1"), ("B2", "rays.count"),
                  ("regroup", "rays.regroup"), ("decode and B3", "rays.emit"),
                  ("merge", "rays.merge"), ("finish", "rays.finish"))

    def ray_query(alg=None):
        return ib.traverse_rays_tiles_fixed(ray_bvh, rp, rd, RAY_CAPACITY,
                                            alg=alg)

    ray_ms = time_ms(ray_query)
    log(f"time: ray query end to end, two-phase ({N_RAYS} rays, "
        f"{N_RAY_TRIS} leaves): {ray_ms:.4f} ms [{card}]")
    stages = [span_ms(ray_query, ray_stages) for _ in range(7)]
    log("time: ray stages (median of 7) "
        + ", ".join(f"{n} {statistics.median(t[n] for t in stages):.4f} ms"
                    for n in stages[0]) + f" [{card}]")
    log(f"time: host enqueue of one ray query: {host_ms(ray_query):.4f} "
        f"ms (median of 7) [{card}]")
    profile_step(torch, ray_query, ray_ms, "ray two-phase", card)
    rayfb_ms = time_ms(lambda: ray_query(ray_fallback), reps=3)
    log(f"time: ray query end to end, fallback {FALLBACK}: {rayfb_ms:.4f} ms "
        f"(median of 3) [{card}]")

    # the full-width pair query (traversal only, on the two built BVHs)
    pair_stages = {   # the two-phase route's first tiles.phase1 span is
        # the superpairs, its second B1 and the run lists
        "two-phase": (("tile the leaves", "tiles.fields"),
                      ("phase 1a (superpairs)", "tiles.phase1"),
                      ("phase 1b (B1, run lists)", "tiles.phase1"),
                      ("B2", "tiles.count"), ("regroup", "tiles.regroup"),
                      ("B3", "tiles.emit"), ("merge", "tiles.merge"),
                      ("finish", "tiles.finish")),
        "fallback": (("tile the leaves", "tiles.fields"),
                     ("phase 1 (with B1, B5) and group", "tiles.phase1"),
                     ("B4", "tiles.emit"),
                     ("extract and finish", "tiles.finish")),
    }
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        def pair_query(alg=alg):
            return ib.traverse_tiles_pair_fixed(
                bvh, bvh2, PAIR_CAPACITY, alg=alg,
                pair_capacity=PAIR_PAIR_CAPACITY)
        pair_ms = time_ms(pair_query)
        log(f"time: pair query end to end, {route} ({N_BENCH} x {N_BODY2} "
            f"leaves): {pair_ms:.4f} ms [{card}]")
        stages = [span_ms(pair_query, pair_stages[route])
                  for _ in range(7)]
        log(f"time: pair stages, {route} (median of 7) "
            + ", ".join(f"{n} {statistics.median(t[n] for t in stages):.4f} "
                        f"ms" for n in stages[0]) + f" [{card}]")
        log(f"time: host enqueue of one pair query, {route}: "
            f"{host_ms(pair_query):.4f} ms (median of 7) [{card}]")
        profile_step(torch, pair_query, pair_ms, f"pair {route}", card)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def slot_tests(ti, tj, band, live, G, dedup):
        """Leaf tests of the slot kernels: G per live row of a live entry,
        under dedup the rows after it on a diagonal (ti == tj) entry."""
        BH = G // 4
        rows = torch.arange(G, device=dev).view(4, BH)
        per_band = torch.stack([torch.full((4,), BH * G, device=dev),
                                (G - 1 - rows).sum(1)])        # (2, 4)
        bits = torch.stack([(band >> r) & 1 for r in range(4)], 1)
        diag = (ti == tj) & bool(dedup)
        t = (bits * per_band[diag.long()]).sum(1)
        return int((t * live).sum())

    def bound(name, args, kw):
        """(bytes_ms, operations_ms): the bytes over the memory rate (inputs
        read once, outputs written once) and the float operations this
        run's data needs over the rate of their type (fp32 or fp64); the
        bound is the larger."""
        ops_n = 0
        rate = FP64_OPS_PER_S if is_f64(args) else FP32_OPS_PER_S
        if name == "subtile_band_bits":
            sub, tl, si, sj, nsp = args
            out_b = si.shape[0] * 32 * 32 * 4
            ar = torch.arange(32, device=dev)
            tii = si[:, None].long() * 32 + ar
            tjj = sj[:, None].long() * 32 + ar
            live = (torch.arange(si.shape[0], device=dev) < nsp)[:, None, None]
            valid = live & (tii < sub.shape[1])[:, :, None] & \
                (tjj < tl.shape[1])[:, None, :]
            if kw.get("triangle", True):
                valid = valid & (tii[:, :, None] <= tjj[:, None, :])
            ops_n = int(valid.sum()) * sub.shape[2] * 6
            b = nbytes(sub, tl, si, sj, nsp) + out_b
        elif name == "tile_run_counts":
            # the tests of the live steps' live bands (the path's
            # num_checks); with moments the word rows of the live pairs,
            # the only rows the function defines and the kernel writes
            a_idx, run_idx, bm, nsteps, *fields = args
            G = fields[0].shape[2]
            W = run_idx.shape[0] // a_idx.shape[0]
            step_live = (torch.arange(run_idx.shape[0], device=dev) // W) < \
                nsteps.clamp(max=a_idx.shape[0])
            tests = int((tiles._popcount(bm) * step_live).sum()) * \
                (G // kw["NB"]) * G
            rows_out = run_idx.shape[0] * kw["R"]
            rows_live = int(ops.run_live_pairs(
                run_idx, bm, nsteps, a_idx.shape[0], fields[-1].shape[1],
                R=kw["R"], NB=kw["NB"]).sum()) if kw.get("moments") else 0
            b = nbytes(a_idx, run_idx, bm, nsteps, *set(fields)) + \
                2 * rows_out * 4 + rows_live * 128 * 4
            ops_n = tests * FLOPS_PER_TEST[kw["mask_kind"]]
        elif name == "tile_group_emit":
            a_idx, b_idx, nsteps, *fields = args
            G = fields[0].shape[2]
            W = b_idx.shape[0] // a_idx.shape[0]
            e = torch.arange(b_idx.shape[0], device=dev)
            live = (((b_idx >> 20) & 0xFF) > 0) & \
                ((e // W) < nsteps.clamp(max=a_idx.shape[0]))
            band = (b_idx >> 16) & 0xF
            nbands = sum(((band >> k) & 1) for k in range(4))
            tests = int((nbands * live).sum()) * (G // 4) * G
            ops_n = tests * FLOPS_PER_TEST[kw["mask_kind"]]
            b = nbytes(a_idx, b_idx, nsteps, *set(fields)) + \
                2 * kw["CAP"] * 4 + 4
        elif name in ("tile_compact", "compact_flat"):
            # the mask is read in full, each payload only in the 32-byte
            # sectors that hold a kept survivor; B5's slots are zeroed and
            # written, counted once, with the per-tile counts and flags;
            # compact_flat keeps the survivors below the capacity and
            # writes the two lists, the total and the flag
            mask, payloads = args
            tiles_n = mask.shape[0] // (128 * 128)
            m = mask.view(tiles_n, 128, 128)
            mi = m.int()
            rank = mi.cumsum(2) - mi
            row_cnt = mi.sum(2)
            row_off = row_cnt.cumsum(1) - row_cnt
            kept = m & (rank < kw["row_cap"]) & \
                (row_off[:, :, None] + rank < kw["cap"])
            out_b = (len(payloads) * kw["cap"] + 2) * tiles_n * 4
            if name == "compact_flat":
                capped = row_cnt.sum(1).clamp(max=kw["cap"])
                base = capped.cumsum(0) - capped
                kept &= base[:, None, None] + row_off[:, :, None] + rank < \
                    kw["capacity"]
                out_b = (len(payloads) * kw["capacity"] + 2) * 4
            sectors = int(kept.view(-1, 8).any(1).sum())
            b = nbytes(mask) + len(payloads) * sectors * 32 + out_b
        else:  # the slot kernels: the lanes below each count are written
            if name == "tile_group_contacts":
                a_idx, b_idx, nsteps, *fields = args
                W = b_idx.shape[0] // a_idx.shape[0]
                e = torch.arange(b_idx.shape[0], device=dev)
                ti, tj = a_idx[e // W], b_idx & 0xFFFF
                band = (b_idx >> 16) & 0xF
                live = (e // W) < nsteps.clamp(max=a_idx.shape[0])
                ins = (a_idx, b_idx, nsteps, *set(fields))
            else:
                packed, npairs, *fields = args
                ti, tj = (packed >> 16) & 0xFFFF, packed & 0xFFFF
                band = torch.full_like(ti, 0xF)
                live = torch.arange(packed.shape[0], device=dev) < npairs
                ins = (packed, npairs, *set(fields))
            fa, fb = fields[0], fields[-1]      # the a set, the b set
            G = fa.shape[2]
            live = live & (ti < fa.shape[1]) & (tj < fb.shape[1])
            if kw["dedup"]:
                live = live & (ti <= tj)
            ops_n = slot_tests(ti, tj, band, live, G, kw["dedup"]) * \
                FLOPS_PER_TEST[kw["mask_kind"]]
            counts = kernels[name][0](*args, **kw)[2]
            lanes = int(counts.clamp(max=kw["CAP_PAIR"]).sum())
            b = nbytes(*ins) + 4 * counts.numel() + 4 + 2 * 4 * lanes
        return b / HBM_BYTES_PER_S * 1e3, ops_n / rate * 1e3

    def device_ms(fn, names, reps=7, tries=3, per_record=False):
        """The device time per call of ``fn`` of the CUDA kernels whose
        names hold one of ``names``, from the profiler's
        ``key_averages()``: the kernels' own time, without the wrapper's
        other work.  The profiler now and then loses a kernel's records: a
        profile that did not record each of ``names`` at least once per
        call is taken again, up to ``tries`` times; after that the time is
        None (not measured), or with ``per_record`` (a wrapper that
        launches each of ``names`` once a call), where the last profile
        kept records of each, the sum over ``names`` of their mean per
        record."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        seen, kept = {}, {}
        for _ in range(tries):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and any(n in e.key for n in names)]
            seen = {e.key: e.count for e in ev}
            if all(sum(e.count for e in ev if n in e.key) >= reps
                   for n in names):
                return sum(e.self_device_time_total for e in ev) / reps / 1e3
            kept = {n: [e for e in ev if n in e.key] for n in names}
        if per_record and all(kept.values()):
            log(f"the profiler kept {seen} records of {reps} calls in the "
                f"last of {tries} profiles: the device time is the sum of "
                "each kernel's mean per record")
            return sum(sum(e.self_device_time_total for e in k) /
                       sum(e.count for e in k) for k in kept.values()) / 1e3
        log(f"the profiler lost records of {names} in {tries} profiles "
            f"(the last one's records of {reps} calls: {seen}): their "
            "device time is not measured")
        return None

    def fmt_ms(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    launches = dict(launches_fb)
    launches.update({n: launches_2p[n] for n in two_phase_kernels})
    # every kernel at its self-contact inputs, then its variants: B2 with
    # moment words at the bench scene; the ray_sphere variants at the
    # full-width ray scene and the ray_box ones at the box-leaf scene, each
    # with the launches counted in its route's run (B6 is on no path: its
    # count over both routes' runs)
    row_specs = [(name, inputs[name], launches[name])
                 for name in tile_kernels]
    row_specs.append(("tile_run_counts", seen_dec["tile_run_counts"],
                      launches_dec["tile_run_counts"]))
    for seen, l2p, lfb in ((seen_ray, launches_ray, launches_rayfb),
                           (seen_box, launches_box["two-phase"],
                            launches_box["fallback"])):
        row_specs += [(n, seen[n], l2p[n]) for n in ray_two_phase_kernels]
        slot_args, slot_kw = seen["tile_group_contacts"]
        row_specs += [
            ("tile_group_contacts", seen["tile_group_contacts"],
             lfb["tile_group_contacts"]),
            ("tile_pair_contacts", (ray_pair_list(slot_args), slot_kw),
             l2p["tile_pair_contacts"] + lfb["tile_pair_contacts"])]
    # the two-tree variants at the full-width pair scene
    pair_rows = len(row_specs)
    row_specs += [(n, seen_pair[n], pair_runs["two-phase"][1][n])
                  for n in two_phase_kernels]
    row_specs += [(n, seen_pair_fb[n], pair_runs["fallback"][1][n])
                  for n in fallback_kernels[1:]]      # B1: the row above
    row_specs.append(("tile_compact", compact_inputs(seen_pair_fb),
                      pair_runs["fallback"][1]["tile_compact"]))
    rows = []
    for k, (name, (args, kw), n_launches) in enumerate(row_specs):
        wrapper, plain, source, replaces = kernels[name]
        row = row_of(name, kw, pair=k >= pair_rows)
        k_ms = time_ms(lambda: wrapper(*args, **kw))
        p_ms = time_ms(lambda: plain(*args, **kw), reps=3)
        bytes_ms, ops_ms = bound(name, args, kw)
        b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
            (ops_ms, "operations")
        lib_ms = None
        if name in ("tile_compact", "compact_flat"):
            # yardstick only: the same survivors, in the same order when
            # nothing overflows; the port never calls it
            mask, payloads = args
            stacked = torch.stack(payloads)
            lib_ms = time_ms(lambda: torch.masked_select(stacked, mask))
            want = torch.masked_select(stacked, mask).view(len(payloads), -1)
            M = mask.shape[0]
        if name == "tile_compact":
            slots, counts, _ = wrapper(*args, **kw)
            flat, n = ops.finish_compact(slots, counts, M)
            if not torch.equal(torch.stack(flat)[:, :int(n)], want):
                raise AssertionError("tile_compact + finish_compact differ "
                                     "from torch.masked_select")
        if name == "compact_flat":
            # like for like: the whole compaction at capacity M, where the
            # lists hold every survivor, beside the old composition
            kw_m = dict(kw, capacity=M)
            flat, n, _ = wrapper(*args, **kw_m)
            if not torch.equal(torch.stack(flat)[:, :int(n)], want) or \
                    not torch.equal(torch.stack(flat),
                                    torch.stack(plain(*args, **kw_m)[0])):
                raise AssertionError("compact_flat differs from "
                                     "torch.masked_select or its plain "
                                     "version at capacity M")
            tc_kw = {k: v for k, v in kw.items() if k != "capacity"}
            flat_ms = time_ms(lambda: wrapper(*args, **kw_m))
            flat_dev = device_ms(lambda: wrapper(*args, **kw_m),
                                 device_kernel[name])
            both_ms = time_ms(lambda: ops.finish_compact(
                *ops.tile_compact(*args, **tc_kw)[:2], M))
            log(f"time: {row} like for like (capacity = the mask's "
                f"length {M}, the lists equal torch.masked_select's): "
                f"compact_flat {flat_ms:.4f} ms (device {fmt_ms(flat_dev)}), "
                f"tile_compact + finish_compact {both_ms:.4f} ms, "
                f"torch.masked_select {lib_ms:.4f} ms [{card}]")
        log(f"time: {row} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"launches {n_launches}, bound {b_ms:.6f} ms ({b_by}; bytes "
            f"{bytes_ms:.6f}, operations {ops_ms:.6f}; without FMA the "
            f"instruction floor of the operations is {2 * ops_ms:.6f}) "
            f"[{card}]")
        d_ms = device_ms(lambda: wrapper(*args, **kw), device_kernel[name])
        log(f"time: {row} {' + '.join(device_kernel[name])} on the device "
            f"(profiler, mean of 7 calls) {fmt_ms(d_ms)} [{card}]")
        if name == "subtile_band_bits":
            log(f"{row}: {int(args[4])} live slots of SP_cap "
                f"{args[2].shape[0]}, NB {args[0].shape[2]}, Ta "
                f"{args[0].shape[1]}, Tb {args[1].shape[1]}")
        if k < len(tile_kernels) and name in (
                "tile_run_counts", "tile_group_emit", "tile_group_contacts"):
            # the dead grid: the same inputs with no live step
            dead = list(args)
            i = 3 if name == "tile_run_counts" else 2
            dead[i] = torch.zeros_like(args[i])
            log(f"time: {row} with nsteps = 0 (the dead grid) "
                f"{time_ms(lambda: wrapper(*dead, **kw)):.4f} ms [{card}]")
        rows.append({"name": row, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n_launches,
                     "max_abs_err": errs[row], "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
                     "library_ms": lib_ms})

    # 16. breadth-first traversal on the card (torch ops, no kernel): the
    # sets of the tile engine and the brute forces, no host sync in the
    # bfs_*_fixed functions at the wrapper's final capacity
    t_new = time.perf_counter()

    def run_bfs(label, query, fixed, keys_of, want):
        """``query()`` (a wrapper with growth) timed once, its tries and
        peak memory; its key set against ``want``; ``fixed(capacity)``
        under the sync check at the final capacity, overflow 0, the same
        total; then the wrapper's median of 7 (CUDA events)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracing.reset("bfs.runs")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = query()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        tries = tracing.counter("bfs.runs")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if out.cache1.device.type != "cuda" or not torch.equal(
                keys_of(out.num_contacts, out.cache1), want):
            raise AssertionError(f"BFS, {label}: the set differs")
        cap = out.cache1.shape[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            total, _, checks, overflow = fixed(cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if int(overflow) != 0 or int(total) != out.num_contacts or \
                int(checks) != out.num_checks:
            raise AssertionError(f"BFS, {label}: the fixed call at capacity "
                                 f"{cap} differs from the wrapper's")
        ms = time_ms(query)
        log(f"time: BFS (torch ops, no kernel), {label}: {ms:.4f} ms "
            f"(median of 7), {once:.1f} ms the first call; "
            f"{out.num_contacts} contacts, num_checks {out.num_checks}, "
            f"{tries} growth tries to capacity {cap}, peak memory "
            f"{peak:.3f} GiB, kernel launches "
            f"{sum(launch_counts().values())}; the fixed call at that "
            f"capacity: overflow 0, no host sync [{card}]")

    sl = ib.default_start_level(bvh, ib.BFSTraversal())
    run_bfs(f"self-contact, {N_BENCH} leaves, start level {sl}",
            lambda: ib.traverse(bvh, ib.BFSTraversal()),
            lambda c: bfs.bfs_single_fixed(bvh, sl, c),
            lambda n, c: check_contacts(n, c, 0, spheres, "BFS"), keys_2p)
    for (b1, b2), (n1, n2), want, label in (
            (c4_bvh, N_PAIR4, keys_c4, "config 4's pair scene"),
            ((bvh, bvh2), (N_BENCH, N_BODY2), keys_union,
             "the full-width pair scene")):
        sl1 = ib.default_start_level(b1, ib.BFSTraversal())
        sl2 = ib.default_start_level(b2, ib.BFSTraversal())
        run_bfs(f"{label}, {n1} x {n2} leaves, start levels {sl1}, {sl2}",
                lambda: ib.traverse(b1, b2, ib.BFSTraversal()),
                lambda c: bfs.bfs_pair_fixed(b1, b2, sl1, sl2, c),
                lambda n, c: pair_keys(n, c, 0, n1, n2, "BFS pair"), want)
    run_bfs(f"the full-width ray scene, {N_RAYS} rays x {N_RAY_TRIS} leaves, "
            "start level 1",
            lambda: ib.traverse_rays(ray_bvh, rp, rd, ib.BFSTraversal()),
            lambda c: bfs.bfs_rays_fixed(ray_bvh, tuple(rp), tuple(rd), 1, c),
            lambda n, c: hit_keys(n, c, 0, N_RAY_TRIS, N_RAYS, "BFS rays"),
            keys_bf)
    log(f"BFS: self-contact, both pair scenes and the ray scene give the "
        f"sets above ({TPU_BENCH_CONTACTS} contacts, {TPU_PAIR4_CONTACTS} and "
        f"{keys_union.numel()} pairs, {TPU_RAY_HITS} hits)")
    t_bfs = time.perf_counter() - t_new

    # 17. depth-first self-contact on the card: kernel W2, each lane's
    # stack in rounds of work items, no host sync; the
    # tile engine's set on the ray scene's BVH, then phase 2's at 1M
    dfs_seen = {}      # label -> (W2's write-pass call, its launches)

    def run_dfs(label, target, sph, want, parent_s):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with recorded_inputs() as seen:
            t0 = time.perf_counter()
            out = ib.traverse(target, ib.DFSTraversal())
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        if out.cache1.device.type != "cuda" or not torch.equal(
                check_contacts(out.num_contacts, out.cache1, 0, sph,
                               f"DFS, {label}"), want):
            raise AssertionError(f"DFS, {label}: the set differs from the "
                                 "tile engine's")
        launches = launch_counts()
        if launches["dfs_lanes"] != 2:
            raise AssertionError(f"DFS, {label}: W2 did not run its two "
                                 f"passes: {launches}")
        log(f"time: DFS (W2), {label}: {sec:.3f} s once, "
            f"{out.num_contacts} contacts (the tile engine's set), launches "
            f"{ {n: v for n, v in launches.items() if v} } (the parent's "
            f"torch-op loop: {parent_s}) [{card}]")
        dfs_seen[label] = (seen["dfs_lanes"], launches["dfs_lanes"])
        return out

    t_dfs0 = time.perf_counter()
    tile_ray_self = ib.traverse(ray_bvh, ib.TileTraversal())
    keys_ray_self = check_contacts(tile_ray_self.num_contacts,
                                   tile_ray_self.cache1, 0, ray_spheres,
                                   "tile self-contact, ray scene")
    del tile_ray_self
    run_dfs(f"self-contact, {N_RAY_TRIS} leaves, start level "
            f"{ib.default_start_level(ray_bvh, ib.DFSTraversal())}",
            ray_bvh, ray_spheres, keys_ray_self,
            "69.3-100.6 s on an H100 80GB HBM3, PERF.md section 5")
    out = run_dfs(f"self-contact, {N_BENCH} leaves, start level "
                  f"{ib.default_start_level(bvh, ib.DFSTraversal())}",
                  bvh, spheres, keys_2p, "never run on the card")
    if out.num_contacts != TPU_BENCH_CONTACTS:
        raise AssertionError(f"DFS at {N_BENCH} leaves: {out.num_contacts} "
                             f"contacts, not {TPU_BENCH_CONTACTS}")
    log(f"DFS at {N_BENCH} leaves: {out.num_contacts} contacts, phase 2's "
        "set")
    del out
    t_dfs = time.perf_counter() - t_dfs0
    log(f"time: phases 16 (BFS) {t_bfs:.1f} s and 17 (DFS) {t_dfs:.1f} s; "
        f"the script so far {time.perf_counter() - t_script:.1f} s")

    # 18. the extended Morton order at the bench scene: codes on the card
    # against the port's CPU codes, the contact set of phase 2, the fixed
    # call at phase 2's caps and the wrapper's growth, the build's time
    t18 = time.perf_counter()
    spheres_cpu = ib.BSphere(tuple(x.cpu() for x in spheres.xs),
                             spheres.r.cpu())
    sign = -1 << 63

    def counting_fixed():
        """``tiles.traverse_tiles_fixed`` wrapped to count the growth
        wrapper's tries (it calls the function by name)."""
        inner = tiles.traverse_tiles_fixed

        def call(*args, **kw):
            call.tries += 1
            return inner(*args, **kw)
        call.tries = 0
        return inner, call

    build_opts = {"default": ib.BVHOptions()}
    for bits in (32, 64):
        alg = ib.ExtendedMortonAlgorithm(bits=bits)
        name = f"extended {bits}-bit"
        codes = ib.morton_encode_extended(spheres, alg)
        codes_cpu = ib.morton_encode_extended(spheres_cpu, alg)
        if not torch.equal(codes.cpu(), codes_cpu):
            raise AssertionError(f"{name}: the codes on the card differ from "
                                 "the CPU's")
        ebvh = ib.build(spheres, options=ib.BVHOptions(morton=alg))
        want = torch.sort(codes_cpu ^ sign, stable=True).values ^ sign
        if not torch.equal(ebvh.leaves.morton.cpu(), want):
            raise AssertionError(f"{name}: the build's leaves are not in the "
                                 "codes' unsigned order")
        n_top = int((codes < 0).sum())
        (e_total, _, e_ov, _), e_launches = \
            main_path(ebvh, two_phase)
        inner, call = counting_fixed()
        tiles.traverse_tiles_fixed = call
        try:
            t = ib.traverse(ebvh)
        finally:
            tiles.traverse_tiles_fixed = inner
        keys = check_contacts(t.num_contacts, t.cache1, 0, spheres,
                              f"traverse(bvh), {name}")
        if t.tile_alg is None or not torch.equal(keys, keys_2p):
            raise AssertionError(f"{name}: traverse(bvh) differs from phase "
                                 "2's set")
        build_opts[name] = ib.BVHOptions(morton=alg)
        log(f"{name} order, bench scene: codes on the card == the CPU's "
            f"(exact, {n_top} of {N_BENCH} set bit 63), leaves in unsigned "
            f"code order; traverse_tiles_fixed at phase 2's caps: "
            f"{int(e_total)} contacts, overflow bits {int(e_ov)}, no host "
            f"sync, launches {e_launches}; traverse(bvh): "
            f"{t.num_contacts} contacts (phase 2's set) after {call.tries} "
            f"tries, capacity {t.cache1.shape[0]}, pair capacity "
            f"{t.pair_capacity}, {t.tile_alg}")
        del t, ebvh, codes, codes_cpu
    build_ms = {k: [] for k in build_opts}
    for k in [*build_opts, *reversed(build_opts)]:    # in turns
        build_ms[k].append(time_ms(
            lambda: ib.build(spheres, options=build_opts[k])))
    log("time: build at the bench scene (median of 7, each order twice in "
        "turns; no host sync in either order) "
        + ", ".join(f"{k} {a:.4f} / {b:.4f} ms"
                    for k, (a, b) in build_ms.items()) + f" [{card}]")
    del spheres_cpu
    t_ext = time.perf_counter() - t18

    # 19. 64-bit user indices: the 1M self scene and the full-width ray
    # scene on both routes, config 4's pair scene on both routes, BFS; the
    # int32 runs' sets and launches
    t19 = time.perf_counter()
    opts64 = ib.BVHOptions(index_bits=64)

    def int64_run(label, out, launches, want_launches, keys_of, want):
        total, contacts, overflow, _ = out
        if contacts.dtype != torch.int64:
            raise AssertionError(f"{label}: contacts are {contacts.dtype}")
        if launches != want_launches:
            raise AssertionError(f"{label}: launches {launches}, at int32 "
                                 f"{want_launches}")
        if not torch.equal(keys_of(total, contacts, overflow), want):
            raise AssertionError(f"{label}: the set differs from int32's")
        log(f"{label}: {int(total)} int64 contacts, the int32 run's set, "
            f"overflow 0, no host sync, launches {launches} (as at int32)")

    bvh64 = ib.build(spheres, options=opts64)
    if bvh64.leaves.index.dtype != torch.int64 or \
            not torch.equal(bvh64.leaves.index, bvh.leaves.index.long()):
        raise AssertionError("index_bits=64: the build differs from int32's")
    for route, alg, want_l in (("two-phase", two_phase, launches_2p),
                               ("fallback", fallback, launches_fb)):
        out, launches = main_path(bvh64, alg)
        int64_run(f"index_bits=64, bench scene, {route}", out, launches,
                  want_l, lambda t, c, o: check_contacts(
                      int(t), c, int(o), spheres, "int64"), keys_2p)
    ray_bvh64 = ib.build(ray_spheres, options=opts64)
    for route, alg, want_l in (("two-phase", None, launches_ray),
                               ("fallback", ray_fallback, launches_rayfb)):
        out, launches = ray_path(ray_bvh64, rp, rd, RAY_CAPACITY, alg)
        int64_run(f"index_bits=64, ray scene, {route}", out, launches,
                  want_l, lambda t, c, o: hit_keys(
                      t, c, o, N_RAY_TRIS, N_RAYS, "int64 rays"), keys_bf)
    c4_bvh64 = [ib.build(v, options=opts64) for v in c4]
    for route, alg in (("two-phase", None), ("fallback", fallback)):
        out, launches = pair_path(*c4_bvh64, PAIR4_CAPACITY, alg)
        int64_run(f"index_bits=64, config 4 scene, {route}", out, launches,
                  launches_c4_of[route], lambda t, c, o: pair_keys(
                      t, c, o, *N_PAIR4, "int64 pair"), keys_c4)
    del ray_bvh64
    bfs32 = ib.traverse(c4_bvh[0], ib.BFSTraversal())
    keys_bfs32 = check_contacts(bfs32.num_contacts, bfs32.cache1, 0, c4[0],
                                "BFS int32, config 4's first body")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bfs64 = ib.traverse(c4_bvh64[0], ib.BFSTraversal())
    if bfs64.cache1.dtype != torch.int64 or not torch.equal(
            check_contacts(bfs64.num_contacts, bfs64.cache1, 0, c4[0],
                           "BFS int64"), keys_bfs32):
        raise AssertionError("index_bits=64: BFS at config 4's first body "
                             "differs from int32's")
    log(f"index_bits=64, traverse(bvh, BFSTraversal()) at config 4's first "
        f"body ({N_PAIR4[0]} leaves): {bfs64.num_contacts} int64 contacts, "
        f"the int32 run's set, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    del bfs32, bfs64, c4_bvh64
    for width, b in (("int32", bvh), ("int64", bvh64)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        bfs1m = ib.traverse(b, ib.BFSTraversal())
        torch.cuda.synchronize()
        if bfs1m.cache1.dtype != b.skips.dtype or not torch.equal(
                check_contacts(bfs1m.num_contacts, bfs1m.cache1, 0, spheres,
                               f"BFS {width} 1M"), keys_2p):
            raise AssertionError(f"BFS at the bench scene, {width}: the set "
                                 "differs from phase 2's")
        log(f"traverse(bvh, BFSTraversal()) at the bench scene, {width} "
            f"indices: {bfs1m.num_contacts} contacts (phase 2's set), "
            f"capacity {bfs1m.cache1.shape[0]}, peak memory "
            f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} GiB "
            f"above the {base / 2 ** 30:.3f} GiB the script held [{card}]")
        del bfs1m

    def step64(p1, p2, p3, alg):
        b = ib.build(ib.bsphere_from_triangles(p1, p2, p3), options=opts64)
        return ib.traverse_tiles_fixed(b, capacity, alg=alg)

    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        runs = {"int32": lambda: step(*tris, capacity, alg),
                "int64": lambda: step64(*tris, alg)}
        ms = {k: [] for k in runs}
        for k in ("int32", "int64", "int64", "int32"):   # in turns
            ms[k].append(time_ms(runs[k]))
        log(f"time: bench step end to end, {route}, index_bits=64 "
            f"{ms['int64'][0]:.4f} / {ms['int64'][1]:.4f} ms, int32 "
            f"{ms['int32'][0]:.4f} / {ms['int32'][1]:.4f} ms (median of 7 "
            f"each, in turns 32, 64, 64, 32); host enqueue int64 "
            f"{host_ms(runs['int64']):.4f} ms, int32 "
            f"{host_ms(runs['int32']):.4f} ms [{card}]")
    del bvh64
    t_i64 = time.perf_counter() - t19

    # 20. the 249,882-triangle reference scene (benchmarks/dragon_table.py:
    # the same draws, the same casts): both contact routes and both ray
    # routes, against brute forces on the card; the reference table's rows
    t20 = time.perf_counter()
    d_tris = to_dev(synth_triangles(N_DRAGON, seed=0), dev)
    dp, dd = (torch.as_tensor(x, device=dev) for x in bench_rays(N_DRAGON))
    d_sph = ib.bsphere_from_triangles(*d_tris)
    d_bvh = ib.build(d_sph)
    def brute_force_self_keys(sph, tests=1 << 25):
        """``check_contacts``' keys from ``iscontact`` of every pair ``i <
        j`` of the spheres ``sph``, ``tests`` pairs at a time."""
        n = sph.batch_shape[0]
        rows = max(1, tests // n)
        keys = []
        for k0 in range(0, n, rows):      # the upper triangle, i < j
            a = sph[k0:k0 + rows]
            a = ib.BSphere(tuple(x[:, None] for x in a.xs), a.r[:, None])
            i, j = ib.iscontact(a, sph[k0:]).nonzero(as_tuple=True)
            keep = i < j
            keys.append((i[keep] + k0) * N_BENCH + (j[keep] + k0))
        return torch.cat(keys).sort().values

    t0 = time.perf_counter()
    keys_dragon = brute_force_self_keys(d_sph)
    log(f"reference scene: brute force of {N_DRAGON * (N_DRAGON - 1) // 2} "
        f"sphere pairs on the card, {keys_dragon.numel()} contacts, "
        f"{time.perf_counter() - t0:.3f} s")
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        (c_total, c_contacts, c_ov, c_checks), launches = counted(
            lambda: ib.traverse_tiles_fixed(d_bvh, DRAGON_CAPACITY, alg=alg))
        label = f"reference scene, {route}"
        keys = check_contacts(int(c_total), c_contacts, int(c_ov), d_sph,
                              label)
        if int(c_total) != TPU_DRAGON_CONTACTS or \
                not torch.equal(keys, keys_dragon):
            raise AssertionError(f"{label}: {int(c_total)} contacts, not the "
                                 f"brute force's {TPU_DRAGON_CONTACTS}")
        log(f"{label}: {N_DRAGON} triangles, capacity {DRAGON_CAPACITY}, "
            f"{int(c_total)} contacts (the JAX package reported "
            f"{TPU_DRAGON_CONTACTS} on a TPU v5e), the brute force's set, "
            f"overflow 0, no duplicates, no host sync, num_checks "
            f"{float(c_checks):.0f}, launches {launches}")
    t0 = time.perf_counter()
    keys_dragon_rays = brute_force_keys(d_sph, dp, dd)
    log(f"reference scene: brute force of {N_RAYS} x {N_DRAGON} ray tests "
        f"on the card, {keys_dragon_rays.numel()} hits, "
        f"{time.perf_counter() - t0:.3f} s")
    for route, alg in (("two-phase", None), ("fallback", ray_fallback)):
        (h_total, h_contacts, h_ov, h_checks), launches = ray_path(
            d_bvh, dp, dd, DRAGON_RAY_CAPACITY, alg)
        label = f"reference scene rays, {route}"
        keys = hit_keys(h_total, h_contacts, h_ov, N_DRAGON, N_RAYS, label)
        if int(h_total) != TPU_DRAGON_HITS or \
                not torch.equal(keys, keys_dragon_rays):
            raise AssertionError(f"{label}: {int(h_total)} hits, not the "
                                 f"brute force's {TPU_DRAGON_HITS}")
        log(f"{label}: {N_RAYS} rays, capacity {DRAGON_RAY_CAPACITY}, "
            f"{int(h_total)} hits (the JAX package reported "
            f"{TPU_DRAGON_HITS} on a TPU v5e), the brute force's set, "
            f"overflow 0, no duplicates, no host sync, num_checks "
            f"{float(h_checks):.0f}, launches {launches}")
    del c_contacts, h_contacts
    table = {
        "bounding spheres": lambda: ib.bsphere_from_triangles(*d_tris),
        "build (spheres -> build, as dragon_table.py's row)":
            lambda: ib.build(ib.bsphere_from_triangles(*d_tris)),
        "build alone": lambda: ib.build(d_sph),
        "contact step (spheres -> build -> traverse_tiles_fixed)":
            lambda: step(*d_tris, DRAGON_CAPACITY, two_phase),
        f"{N_RAYS} rays on the prebuilt tree (traverse_rays_tiles_fixed)":
            lambda: ib.traverse_rays_tiles_fixed(d_bvh, dp, dd,
                                                 DRAGON_RAY_CAPACITY),
    }
    for row, fn in table.items():
        ms = time_ms(fn)
        log(f"time: reference table, {row}: {ms:.4f} ms (median of 7), host "
            f"enqueue {host_ms(fn):.4f} ms [{card}]")
        if row.startswith(("contact", f"{N_RAYS} rays")):
            profile_step(torch, fn, ms, f"reference table, {row}", card)
    del d_bvh, d_sph, d_tris, dp, dd
    t_dragon = time.perf_counter() - t20
    log(f"time: phases 18 (extended order) {t_ext:.1f} s, 19 (64-bit "
        f"indices) {t_i64:.1f} s and 20 (reference scene) {t_dragon:.1f} s; "
        f"the script {time.perf_counter() - t_script:.1f} s")

    # 21. sharding (parallel/sharding.py) on the card: a NCCL world of 1
    # through the public functions, 8 virtual ranks through the local
    # functions, the JAX package's multichip scenes, timings
    t21 = time.perf_counter()
    import torch.distributed as dist
    from implicitbvh_tpu_torch import parallel
    from implicitbvh_tpu_torch.parallel import sharding

    def split_keys(label, n_dev, run_rank, keys_of, want):
        """``run_rank(rank)`` (a local function) for every rank, each under
        the sync check with its launches counted; per-rank counts and, for
        the tile self and pair paths, live count steps against S_loc.
        Returns None when a rank overflows, else checks that the slices
        are disjoint, their union is ``want`` and the counts sum to its
        size, and returns the counts."""
        counts, keys, lines = [], [], []
        for rank in range(n_dev):
            with slice_steps() as steps:
                (t, c, o), launches = counted(lambda: run_rank(rank))
            if min(launches[n] for n in ("tile_run_counts",
                                         "tile_group_emit")) < 1:
                raise AssertionError(f"{label}, rank {rank}: launches "
                                     f"{launches}")
            t = int(t)
            counts.append(t)
            lines.append(f"rank {rank}: {t} contacts, overflow {bool(o)}"
                         + "".join(f", {int(n)} of S_loc {s} count steps"
                                   for n, s in steps))
            if bool(o):
                log(f"{label}, {n_dev} ranks: rank {rank} overflows at the "
                    f"JAX package's sizing; " + "; ".join(lines))
                return None
            keys.append(keys_of(t, c))
        log(f"{label}, {n_dev} ranks (local functions, each under the sync "
            f"check): " + "; ".join(lines))
        union = torch.cat(keys).sort().values
        if sum(counts) != want.numel() or torch.unique(union).numel() != \
                union.numel() or not torch.equal(union, want):
            raise AssertionError(f"{label}, {n_dev} ranks: the slices are "
                                 "not disjoint or their union differs")
        return counts

    @contextlib.contextmanager
    def slice_steps():
        """The live count steps and S_loc of each superpair slice run
        (``tiles._slice_runs``, called by name)."""
        inner, seen = tiles._slice_runs, []

        def call(*args, **kw):
            out = inner(*args, **kw)
            seen.append((out[3], args[7]))
            return out
        tiles._slice_runs = call
        try:
            yield seen
        finally:
            tiles._slice_runs = inner

    def split(label, run_rank, keys_of, want):
        """``split_keys`` at 8 virtual ranks, else at the largest of 4 and
        2 ranks at which no rank overflows; returns that rank count."""
        for n_dev in (8, 4, 2):
            if split_keys(label, n_dev, lambda k: run_rank(k, n_dev),
                          keys_of, want) is not None:
                return n_dev
        raise AssertionError(f"{label}: a rank overflows at 2 ranks")

    def self_keys(sph):
        return lambda t, c: check_contacts(t, c, 0, sph, "sharded")

    x_b = torch.stack(spheres.xs, 1)          # the bench scene's (N, 3)
    r_b = spheres.r
    cap1 = capacity
    store = os.path.abspath(os.path.join("build",
                                         f"dist_store_{os.getpid()}"))
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        # a. the public functions on a world of 1, each under the sync
        # check: the step (its build included), then each tile call
        stepper = parallel.sharded_rebuild_traverse_step(
            mesh, capacity_per_device=cap1, alg=two_phase)
        stepper(x_b, r_b)
        (s_total, s_con, s_counts, s_ov), s_launch = counted(
            lambda: stepper(x_b, r_b))
        if bool(s_ov) or int(s_total) != TPU_BENCH_CONTACTS or \
                min(s_launch[n] for n in two_phase_kernels) < 1 or \
                not torch.equal(check_contacts(
                    int(s_total), s_con.to_local(), 0, spheres,
                    "sharded step"), keys_2p):
            raise AssertionError(f"sharded step, world of 1: {int(s_total)} "
                                 f"contacts, overflow {bool(s_ov)}, launches "
                                 f"{s_launch}: not phase 2's set")
        if tuple(s_con.shape) != (cap1, 2) or \
                tuple(s_con.to_local().shape) != (cap1, 2) or \
                tuple(s_con.full_tensor().shape) != (cap1, 2) or \
                s_counts.full_tensor().tolist() != [TPU_BENCH_CONTACTS]:
            raise AssertionError("sharded step, world of 1: the DTensor "
                                 "shapes or counts are wrong")
        log(f"sharded_rebuild_traverse_step, NCCL world of 1, bench scene "
            f"({N_BENCH} spheres, capacity {cap1}): {int(s_total)} "
            f"contacts (phase 2's set), overflow False, counts "
            f"{s_counts.full_tensor().tolist()}, no host sync (the build "
            f"included), contacts global "
            f"{tuple(s_con.shape)} local {tuple(s_con.to_local().shape)}, "
            f"launches {s_launch}")
        (p_total, p_con, _, p_ov), p_launch = counted(
            lambda: parallel.sharded_tile_self_contact(mesh, bvh, cap1,
                                                       alg=two_phase))
        if bool(p_ov) or int(p_total) != TPU_BENCH_CONTACTS or \
                min(p_launch[n] for n in two_phase_kernels) < 1:
            raise AssertionError("sharded_tile_self_contact, world of 1: "
                                 "wrong total or launches")
        log(f"sharded_tile_self_contact, NCCL world of 1: {int(p_total)} "
            f"contacts, no host sync (the all-reduce and DTensor.from_local "
            f"included), launches {p_launch}")
        moved = torch.stack([x + 0.05 for x in spheres.xs], 1)
        m_total, m_con, _, m_ov = stepper(moved, r_b)
        m_sph = ib.BSphere(moved, r_b)
        mt, mc, mo, _ = ib.traverse_tiles_fixed(ib.build(m_sph), cap1,
                                                alg=two_phase)
        keys_m = check_contacts(int(mt), mc, int(mo), m_sph,
                                "moved, traverse_tiles_fixed")
        if bool(m_ov) or not torch.equal(check_contacts(
                int(m_total), m_con.to_local(), 0, m_sph, "moved, sharded"),
                keys_m):
            raise AssertionError("sharded step on moved geometry differs "
                                 "from traverse_tiles_fixed")
        log(f"sharded step on moved geometry (x + 0.05): {int(m_total)} "
            f"contacts, traverse_tiles_fixed's set")
        (q_total, q_con, _, q_ov), q_launch = counted(
            lambda: parallel.sharded_tile_pair(mesh, bvh, bvh2, PAIR_CAPACITY,
                                               alg=two_phase))
        if bool(q_ov) or min(q_launch[n] for n in two_phase_kernels) < 1 or \
                not torch.equal(pair_keys(q_total, q_con.to_local(), 0,
                                          N_BENCH, N_BODY2, "sharded pair"),
                                keys_union):
            raise AssertionError("sharded_tile_pair, world of 1: not phase "
                                 "13's set")
        log(f"sharded_tile_pair, NCCL world of 1, full-width pair scene: "
            f"{int(q_total)} contacts (phase 13's set), no host sync, "
            f"launches {q_launch}")
        (h_total, h_con, _, h_ov), h_launch = counted(
            lambda: parallel.sharded_rays(mesh, ray_bvh, rp, rd,
                                          RAY_CAPACITY))
        if bool(h_ov) or int(h_total) != TPU_RAY_HITS or \
                min(h_launch[n] for n in ray_two_phase_kernels) < 1 or \
                not torch.equal(hit_keys(h_total, h_con.to_local(), 0,
                                         N_RAY_TRIS, N_RAYS, "sharded rays"),
                                keys_bf):
            raise AssertionError("sharded_rays, world of 1: not the brute "
                                 "force's set")
        log(f"sharded_rays (tiles), NCCL world of 1, full-width ray scene: "
            f"{int(h_total)} hits (the brute force's set), no host sync, "
            f"launches {h_launch}")
        keys_walk = hit_keys(tile_hits.num_contacts, tile_hits.cache1, 0,
                             N_RAY_TRIS, N_WALK_RAYS, "walk rays")
        (w_total, w_con, _, w_ov), w_launch = counted(
            lambda: parallel.sharded_rays(mesh, ray_bvh, wp, wd, 1 << 12,
                                          engine="walk"))
        if bool(w_ov) or w_launch["walk_lanes"] != 2 or not torch.equal(
                hit_keys(w_total, w_con.to_local(), 0, N_RAY_TRIS,
                         N_WALK_RAYS, "sharded walk rays"), keys_walk):
            raise AssertionError("sharded_rays (walk), world of 1: not the "
                                 f"walk's set, or W1 not launched twice: "
                                 f"{w_launch}")
        log(f"sharded_rays (walk), NCCL world of 1, {N_WALK_RAYS} rays: "
            f"{int(w_total)} hits, phase 14's set, no host sync, W1 "
            f"launches {w_launch['walk_lanes']}")
        x_sph = ib.bsphere_from_triangles(*to_dev(cross, dev))
        x_bvh = ib.build(x_sph)
        xt, xc, xo, _ = ib.traverse_tiles_fixed(x_bvh, cap_x, alg=two_phase)
        keys_x = check_contacts(int(xt), xc, int(xo), x_sph, "cross scene")
        t0 = time.perf_counter()
        (v_total, v_con, _, v_ov), v_launch = counted(
            lambda: parallel.sharded_self_contact(mesh, x_bvh, cap_x))
        if bool(v_ov) or v_launch["walk_lanes"] != 2 or not torch.equal(
                check_contacts(int(v_total), v_con.to_local(), 0, x_sph,
                               "sharded walk"), keys_x):
            raise AssertionError("sharded_self_contact, world of 1: not the "
                                 "tile engine's set, or W1 not launched "
                                 f"twice: {v_launch}")
        log(f"sharded_self_contact (walk), NCCL world of 1, {N_CROSS}-"
            f"triangle scene: {int(v_total)} contacts (the tile engine's "
            f"set), {time.perf_counter() - t0:.3f} s once, no host sync, W1 "
            f"launches {v_launch['walk_lanes']} (the parent's torch-op "
            f"loop: 0.877-1.401 s on an H100 80GB HBM3)")

        # b. 8 virtual ranks through the local functions
        t21b = time.perf_counter()
        n_self = split(
            f"1M self-contact (capacity {cap1} per rank)",
            lambda k, n: sharding._local_sharded_tile_self_contact(
                bvh, cap1, k, n, alg=two_phase),
            self_keys(spheres), keys_2p)
        n_pair = split(
            f"full-width pair (capacity {PAIR_CAPACITY} per rank)",
            lambda k, n: sharding._local_sharded_tile_pair(
                bvh, bvh2, PAIR_CAPACITY, k, n, alg=two_phase),
            lambda t, c: pair_keys(t, c, 0, N_BENCH, N_BODY2, "rank"),
            keys_union)
        n_ray = split(
            f"full-width rays ({N_RAYS // 8} per rank at 8, capacity "
            f"{RAY_CAPACITY} per rank)",
            lambda k, n: sharding._local_sharded_rays(
                ray_bvh, rp, rd, RAY_CAPACITY, k, n),
            lambda t, c: hit_keys(t, c, 0, N_RAY_TRIS, N_RAYS, "rank"),
            keys_bf)
        wcounts = []
        wkeys = []
        w_launches = 0
        t0 = time.perf_counter()
        for k in range(8):
            (t, c, o), launches = counted(
                lambda: sharding._local_sharded_rays(
                    ray_bvh, wp, wd, 1 << 12, k, 8, engine="walk"))
            if bool(o) or launches["walk_lanes"] != 2:
                raise AssertionError(f"walk rays, rank {k}: overflow "
                                     f"{bool(o)}, launches {launches}")
            w_launches += launches["walk_lanes"]
            wcounts.append(int(t))
            wkeys.append(hit_keys(t, c, 0, N_RAY_TRIS, N_WALK_RAYS, "rank"))
        if not torch.equal(torch.cat(wkeys).sort().values, keys_walk):
            raise AssertionError("walk rays, 8 ranks: the union differs")
        log(f"walk rays, 8 ranks ({N_WALK_RAYS // 8} rays each, each under "
            f"the sync check): counts {wcounts}, the union is the world of "
            f"1's set; W1 launches {w_launches}, "
            f"{time.perf_counter() - t0:.3f} s for the eight (the parent's "
            f"torch-op loop: phase 21 b took 67.3-90.8 s on an H100, "
            f"nearly all of it these walks)")

        # c. the JAX package's multichip scenes (__graft_entry__.py:86-140)
        t21c = time.perf_counter()
        def example(n, seed):
            rng = np.random.default_rng(seed)
            scale = float(n) ** (1.0 / 3.0)
            return ((rng.random((n, 3)) * scale).astype(np.float32),
                    (rng.random(n) * 0.4 + 0.05).astype(np.float32))
        dx, dr = (torch.as_tensor(a, device=dev) for a in example(512, 1))
        drng = np.random.default_rng(2)
        dp = torch.as_tensor(drng.random((3, 64)).astype(np.float32) * 4 - 1,
                             device=dev)
        dd = torch.as_tensor(drng.random((3, 64)).astype(np.float32) - 0.5,
                             device=dev)
        dx2, dr2 = (torch.as_tensor(a, device=dev) for a in example(512, 3))
        dalg = ib.TileTraversal(tile=32, row_cap=8, pair_cap=64)
        dbvh = ib.build(ib.BSphere(dx, dr))
        dbvh2 = ib.build(ib.BSphere(dx2, dr2))
        world1 = (
            int(parallel.sharded_rebuild_traverse_step(
                mesh, capacity_per_device=512, alg=dalg)(dx, dr)[0]),
            int(parallel.sharded_rays(mesh, dbvh, dp, dd, 256)[0]),
            int(parallel.sharded_tile_pair(mesh, dbvh, dbvh2, 512,
                                           alg=dalg)[0]))
        virt = [sum(int(fn(k)[0]) for k in range(8)) for fn in (
            lambda k: sharding._local_sharded_rebuild_traverse_step(
                dx, dr, k, 8, capacity_per_device=512, alg=dalg),
            lambda k: sharding._local_sharded_rays(dbvh, dp, dd, 256, k, 8),
            lambda k: sharding._local_sharded_tile_pair(
                dbvh, dbvh2, 512, k, 8, alg=dalg))]
        if world1 != (157, 32, 319) or tuple(virt) != world1:
            raise AssertionError(f"the dry run's scene: world of 1 {world1}, "
                                 f"8 ranks {virt}, not (157, 32, 319)")
        log(f"dryrun_multichip(8)'s scene: contact step {world1[0]}, rays "
            f"{world1[1]}, pair {world1[2]} on the world of 1 and on 8 "
            "virtual ranks (MULTICHIP_r05.json: 157, 32, 319)")
        n15 = 1 << 15
        arng = np.random.default_rng(33)
        a_x = arng.random((n15, 3), dtype=np.float32) * \
            (float(n15) ** (1.0 / 3.0))
        a_r = (arng.random(n15, dtype=np.float32) * 0.4 + 0.05).astype(
            np.float32)
        a_sph = ib.BSphere(a_x, a_r, device=dev)
        a_bvh = ib.build(a_sph)
        a_alg = ib.TileTraversal(row_cap=8, pair_cap=64)
        a_ref = ib.traverse_tiles(a_bvh, alg=a_alg)
        a_counts = split_keys(
            f"the JAX package's at-scale scene ({n15} spheres, seed 33, "
            "4096 per rank)", 8,
            lambda k: sharding._local_sharded_tile_self_contact(
                a_bvh, 4096, k, 8, alg=a_alg),
            self_keys(a_sph), check_contacts(a_ref.num_contacts,
                                             a_ref.cache1, 0, a_sph, "ref"))
        if a_counts is None or sum(n > 0 for n in a_counts) < 4:
            raise AssertionError(f"the at-scale scene: counts {a_counts}")

        # d. timings (CUDA events, median of 7, and the host's enqueue)
        t21d = time.perf_counter()
        def single_step():
            return ib.traverse_tiles_fixed(ib.build(ib.BSphere(x_b, r_b)),
                                           cap1, alg=two_phase)
        runs = {"sharded step": lambda: stepper(x_b, r_b),
                "traverse_tiles_fixed step": single_step}
        ms = {k: [] for k in runs}
        for k in (*runs, *reversed(runs)):
            ms[k].append(time_ms(runs[k]))
        log("time: moving-geometry step at the bench scene (BSphere -> "
            "build -> traversal, world of 1; median of 7 each, in turns) "
            + ", ".join(f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in
                        ms.items())
            + "; host enqueue " + ", ".join(
                f"{k} {host_ms(fn):.4f} ms" for k, fn in runs.items())
            + f" [{card}]")
        for label, n_dev, run_rank in (
                ("1M self-contact", n_self,
                 lambda k, n: sharding._local_sharded_tile_self_contact(
                     bvh, cap1, k, n, alg=two_phase)),
                ("full-width pair", n_pair,
                 lambda k, n: sharding._local_sharded_tile_pair(
                     bvh, bvh2, PAIR_CAPACITY, k, n, alg=two_phase)),
                ("full-width rays", n_ray,
                 lambda k, n: sharding._local_sharded_rays(
                     ray_bvh, rp, rd, RAY_CAPACITY, k, n))):
            per = [time_ms(lambda: run_rank(k, n_dev)) for k in range(n_dev)]
            log(f"time: {label}, {n_dev} virtual ranks (local functions, "
                f"median of 7 each): slowest rank {max(per):.4f} ms, sum "
                f"over ranks {sum(per):.4f} ms, ranks "
                + ", ".join(f"{p:.4f}" for p in per) + f" [{card}]")
        rruns = {"sharded_rays": lambda: parallel.sharded_rays(
                     mesh, ray_bvh, rp, rd, RAY_CAPACITY),
                 "traverse_rays_tiles_fixed": ray_query}
        ms = {k: [] for k in rruns}
        for k in (*rruns, *reversed(rruns)):
            ms[k].append(time_ms(rruns[k]))
        log(f"time: ray query, world of 1 ({N_RAYS} rays, {N_RAY_TRIS} "
            "leaves; median of 7 each, in turns) "
            + ", ".join(f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in
                        ms.items())
            + "; host enqueue " + ", ".join(
                f"{k} {host_ms(fn):.4f} ms" for k, fn in rruns.items())
            + f" [{card}]")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    t_end = time.perf_counter()
    log(f"time: phase 21 (sharding) {t_end - t21:.1f} s (a {t21b - t21:.1f}, "
        f"b {t21c - t21b:.1f}, c {t21d - t21c:.1f}, d {t_end - t21d:.1f}); "
        f"the script {t_end - t_script:.1f} s")

    # 22. the sync-free step: the whole step (triangles or spheres -> build
    # -> tile traversal) under the sync check for every build option, then
    # each tile *_fixed query and the step captured in a CUDA graph and
    # replayed on the captured and on new inputs against the eager call
    t22 = time.perf_counter()
    from implicitbvh_tpu_torch import entry as ib_entry

    # a. the whole step eagerly under the sync check
    e_step, (e_x, e_r) = ib_entry.entry()
    (e_total, _), e_launch = counted(lambda: e_step(e_x, e_r))
    log(f"entry() step ({e_x.shape[0]} spheres): {int(e_total)} contacts, "
        f"no host sync, launches {e_launch}")
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        (_, _, (t, c, o, _)), launches = counted(
            lambda: step(*tris, capacity, alg))
        if int(t) != TPU_BENCH_CONTACTS or not torch.equal(
                check_contacts(int(t), c, int(o), spheres, route), keys_2p):
            raise AssertionError(f"bench step, {route}: not phase 2's set")
        check_pair_launches(launches, route, f"bench step, {route}")
        log(f"bench step, {route} (triangles -> spheres -> build -> "
            f"traverse_tiles_fixed): {int(t)} contacts, phase 2's set, no "
            f"host sync, launches {launches}")
    fixed_bounds = ib.DefaultMortonAlgorithm(
        compute_extrema=False, mins=(-1.0, -1.0, -1.0),
        maxs=(float(N_BENCH) ** (1 / 3) + 1.0,) * 3)
    for name, opts in (
            ("extended 32-bit", ib.BVHOptions(
                morton=ib.ExtendedMortonAlgorithm(bits=32))),
            ("extended 64-bit", ib.BVHOptions(
                morton=ib.ExtendedMortonAlgorithm(bits=64))),
            ("fixed Morton bounds", ib.BVHOptions(morton=fixed_bounds)),
            ("index_bits=64", ib.BVHOptions(index_bits=64))):
        (t, c, o, _), _ = counted(lambda: ib.traverse_tiles_fixed(
            ib.build(ib.bsphere_from_triangles(*tris), options=opts),
            capacity, alg=two_phase))
        if not torch.equal(check_contacts(int(t), c, int(o), spheres, name),
                           keys_2p):
            raise AssertionError(f"bench step, {name}: not phase 2's set")
        log(f"bench step with {name}: {int(t)} contacts, phase 2's set, no "
            "host sync")

    # b-d. CUDA graphs
    def displaced(n, seed=5):
        """A (n, 3) float32 displacement, uniform in [-0.05, 0.05)."""
        rng = np.random.default_rng(seed)
        return torch.as_tensor(
            ((rng.random((n, 3)) - 0.5) * 0.1).astype(np.float32),
            device=dev)

    def bvh_tensors(b):
        return [b.skips, *b.nodes.los, *b.nodes.ups, *b.leaves.volume.xs,
                b.leaves.volume.r, b.leaves.index, b.leaves.morton]

    def pair_summary(out):
        """Total, overflow, num_checks and the sorted contact keys."""
        t, c, o, nc = out
        t = int(t)
        c = c[:min(t, c.shape[0])].long()
        return (t, int(o), float(nc), ((c[:, 0] << 32) | c[:, 1]).sort()
                .values)

    def replay_ops(g, names, tries=3):
        """The device ops of one replay of ``g`` from the profiler, which
        must hold a kernel named by each of ``names`` (a profile that lost
        one is taken again, up to ``tries`` times)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                g.replay()
                torch.cuda.synchronize()
            ran = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            missing = [n for n in names if not any(n in e.key for e in ran)]
            if not missing:
                return sum(e.count for e in ran)
        raise AssertionError(f"the profiler saw no {missing} in a replay "
                             f"({tries} profiles)")

    graph_ms = {}

    def graph_cell(label, run, statics, fresh, summary, check_captured,
                   wrappers=()):
        """Warm ``run`` up on a side stream (the kernels' first build and
        load, ``persistent_blocks``' attribute and occupancy calls), then
        capture it in a CUDA graph with the launch counts set to 0 just
        before and read just after (they count at capture, not at replay);
        replay it on the captured inputs and on ``fresh`` copied into
        ``statics``, each replay's ``summary`` equal to the eager call's on
        the same inputs; check the wrappers' kernels in one replay's
        profile; time eager calls and replays in turns.  At the end the
        captured inputs are copied back into ``statics``, and the graph
        and its pool are released."""
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = run()
        launches = launch_counts()
        captured = [s.clone() for s in statics]
        for k, inputs in enumerate((None, fresh)):
            if inputs is not None:
                for s, f in zip(statics, inputs, strict=True):
                    s.copy_(f)
            g.replay()
            torch.cuda.synchronize()
            got = summary(out)
            if inputs is None:
                check_captured(out)
            want = summary(run())
            if any(not torch.equal(a, b) if torch.is_tensor(a) else a != b
                   for a, b in zip(got, want, strict=True)):
                raise AssertionError(f"{label}: replay {k} differs from the "
                                     "eager call on the same inputs")
        names = [kn for w in wrappers for kn in device_kernel[w]]
        n_ops = replay_ops(g, names)
        ms = {"eager": [], "replay": []}
        for k in ("eager", "replay", "replay", "eager"):
            ms[k].append(time_ms(run if k == "eager" else g.replay))
        host = {"eager": host_ms(run), "replay": host_ms(g.replay)}
        graph_ms[label] = (ms, host)
        log(f"graph, {label}: captured (launches at capture {launches}), "
            f"replayed on the captured and on new inputs, each equal to the "
            f"eager call; {n_ops} device ops in one replay's profile, "
            f"among them {', '.join(names) or 'no kernel of the port'}")
        log(f"time: graph, {label}: eager {ms['eager'][0]:.4f} / "
            f"{ms['eager'][1]:.4f} ms, replay {ms['replay'][0]:.4f} / "
            f"{ms['replay'][1]:.4f} ms (CUDA events, median of 7 each, in "
            f"turns); host per call eager {host['eager']:.4f} ms, replay "
            f"{host['replay']:.4f} ms (median of 7) [{card}]")
        for s, c in zip(statics, captured):
            s.copy_(c)
        del out, captured
        g.reset()
        del g
        torch.cuda.empty_cache()
        return launches

    def want_launches(launches, names, label):
        if min(launches[n] for n in names) < 1:
            raise AssertionError(f"{label}: a kernel was not captured: "
                                 f"{launches}")

    # the entry step: a brute force over its spheres on the captured ones
    gx, gr = e_x.clone(), e_r.clone()
    keys_entry = brute_force_self_keys(ib.BSphere(gx, gr))

    def entry_captured(out):
        t, c = out
        if int(t) < 0 or not torch.equal(check_contacts(
                int(t), c, 0, ib.BSphere(gx, gr), "entry"), keys_entry):
            raise AssertionError(f"entry step: {int(t)}, not the brute "
                                 "force's set")
        log(f"entry step, captured inputs: {int(t)} contacts, overflow bit "
            f"0, the brute force's set ({keys_entry.numel()} pairs)")

    def entry_summary(out):
        t, c = out
        c = c[:max(0, min(int(t), c.shape[0]))].long()
        return int(t), ((c[:, 0] << 32) | c[:, 1]).sort().values

    launches = graph_cell(
        f"entry() step ({e_x.shape[0]} spheres)", lambda: e_step(gx, gr),
        [gx, gr], ib_entry.example_spheres(gx.shape[0], seed=1, device=dev),
        entry_summary, entry_captured, two_phase_kernels)
    want_launches(launches, two_phase_kernels, "entry graph")

    # the bench step on both routes: new triangles of another seed
    g_tris = [p.clone() for tri in tris for p in tri]
    new_tris = [p for tri in to_dev(synth_triangles(N_BENCH, seed=4), dev)
                for p in tri]
    for route, alg, names in (("two-phase", two_phase, two_phase_kernels),
                              ("fallback", fallback, fallback_kernels)):
        def bench_captured(out, route=route):
            t, c, o, _ = out
            if int(t) != TPU_BENCH_CONTACTS or not torch.equal(
                    check_contacts(int(t), c, int(o), spheres, route),
                    keys_2p):
                raise AssertionError(f"bench step graph, {route}: not "
                                     "phase 2's set")

        launches = graph_cell(
            f"bench step, {route}",
            lambda alg=alg: step(*[g_tris[3 * k:3 * k + 3]
                                   for k in range(3)], capacity, alg)[2],
            g_tris, new_tris, pair_summary, bench_captured, names)
        check_pair_launches(launches, route, f"bench step graph, {route}")
    del g_tris, new_tris

    # the full-width pair query: the second body moved
    g_b1, g_b2 = ib.build(spheres), ib.build(body2)   # bvh's and bvh2's
    moved2 = ib.build(ib.BSphere(
        torch.stack(body2.xs, 1) + displaced(N_BODY2), body2.r))
    for route, alg, names in (("two-phase", two_phase, two_phase_kernels),
                              ("fallback", fallback, fallback_kernels)):
        def pair_captured(out, route=route):
            t, c, o, _ = out
            if int(t) != keys_union.numel() or not torch.equal(pair_keys(
                    t, c, o, N_BENCH, N_BODY2, route), keys_union):
                raise AssertionError(f"pair graph, {route}: not phase 13's "
                                     "set")

        launches = graph_cell(
            f"pair query, {route}",
            lambda alg=alg: ib.traverse_tiles_pair_fixed(
                g_b1, g_b2, PAIR_CAPACITY, alg=alg,
                pair_capacity=PAIR_PAIR_CAPACITY),
            bvh_tensors(g_b2), bvh_tensors(moved2), pair_summary,
            pair_captured, names)
        check_pair_launches(launches, route, f"pair graph, {route}")
    del g_b1, g_b2, moved2

    # the full-width ray query: new rays
    g_rp, g_rd = rp.clone(), rd.clone()
    new_rays = [torch.as_tensor(x, device=dev)
                for x in bench_rays(N_RAY_TRIS, seed=6)]
    for route, alg, names in (
            ("ray defaults", None, ray_two_phase_kernels),
            ("fallback", ray_fallback, ray_fallback_kernels)):
        def ray_captured(out, route=route):
            t, c, o, _ = out
            if int(t) != TPU_RAY_HITS or not torch.equal(hit_keys(
                    t, c, o, N_RAY_TRIS, N_RAYS, route), keys_bf):
                raise AssertionError(f"ray graph, {route}: not the brute "
                                     "force's set")

        launches = graph_cell(
            f"ray query, {route}",
            lambda alg=alg: ib.traverse_rays_tiles_fixed(
                ray_bvh, g_rp, g_rd, RAY_CAPACITY, alg=alg),
            [g_rp, g_rd], new_rays, pair_summary, ray_captured, names)
        want_launches(launches, names, f"ray graph, {route}")
    del g_rp, g_rd, new_rays

    # the extended-order build at 32 bits: the spheres moved
    ext32 = ib.BVHOptions(morton=ib.ExtendedMortonAlgorithm(bits=32))
    g_xs, g_r = [x.clone() for x in spheres.xs], spheres.r.clone()
    d = displaced(N_BENCH)
    want_ext = bvh_tensors(ib.build(spheres, options=ext32))

    def ext_captured(out):
        if not all(torch.equal(a, b) for a, b in
                   zip(bvh_tensors(out), want_ext, strict=True)):
            raise AssertionError("extended build graph: not the eager "
                                 "build of the bench spheres")

    graph_cell("extended 32-bit build",
               lambda: ib.build(ib.BSphere(tuple(g_xs), g_r), options=ext32),
               g_xs, [g_xs[k] + d[:, k] for k in range(3)],
               lambda out: [t.clone() for t in bvh_tensors(out)],
               ext_captured)
    del g_xs, g_r, d, want_ext
    t_end22 = time.perf_counter()
    log(f"time: phase 22 (the sync-free step) {t_end22 - t22:.1f} s; the "
        f"script {t_end22 - t_script:.1f} s")

    # 23. the walks on the device: W1 and W2 against their plain versions
    # on every variant, the walk and DFS *_fixed calls under the sync check
    # and captured in CUDA graphs, then their times at phases 14 and 17's
    # scenes beside the plain loops, and their rows of the kernels line
    t23 = time.perf_counter()
    from implicitbvh_tpu_torch.ops import walk as owalk
    from implicitbvh_tpu_torch.traverse.lvt import _scan

    # a. every variant on small scenes, kernel against plain, exactly, in
    # float32 and in float64, and in mixed precisions
    def scene(n, seed, box=False, node_kind=ib.BBox, options=None,
              dtype=np.float32):
        """n spheres (or their boxes) at about unit density."""
        rng = np.random.default_rng(seed)
        x = (rng.random((n, 3)) * float(n) ** (1 / 3)).astype(dtype)
        r = (rng.random(n) * 0.4 + 0.3).astype(dtype)
        sph = ib.BSphere(x, r, device=dev)
        return ib.build(boxes_of(sph) if box else sph, node_kind,
                        options=options or ib.DEFAULT_OPTIONS)

    def ray_lanes(k, seed, scale, dtype=np.float32):
        """Rays with zero direction components, some along an axis, some
        starting in a coordinate plane."""
        rng = np.random.default_rng(seed)
        p = (rng.random((3, k)) * scale).astype(dtype)
        d = (rng.random((3, k)) - 0.5).astype(dtype)
        d[0, :k // 4] = 0.0
        d[1, k // 8:k // 3] = 0.0
        d[:2, k // 2:k // 2 + k // 8] = 0.0
        p[2, :k // 6] = 0.0
        return (tuple(torch.as_tensor(p, device=dev)),
                tuple(torch.as_tensor(d, device=dev)))

    def dedup_of(b):
        return torch.arange(1, b.num_leaves + 1, dtype=b.skips.dtype,
                            device=dev) + (1 << (b.tree.levels - 1)) - 1

    variants = []          # (label, kernel, args, kw, truncate)
    i64 = ib.BVHOptions(index_bits=64)
    for dt, tag in ((np.float32, ""), (np.float64, ", float64")):
        va = scene(1200, 1, dtype=dt)
        vs = scene(800, 2, node_kind=ib.BSphere, dtype=dt)
        vb = scene(1000, 3, box=True, dtype=dt)
        v64 = scene(1200, 1, options=i64, dtype=dt)
        vt = scene(700, 4, dtype=dt)
        vtb = scene(600, 5, box=True, dtype=dt)
        tdt = torch.float64 if dt == np.float64 else torch.float32
        one = ib.build(ib.BSphere(
            torch.full((1, 3), 4.0, dtype=tdt, device=dev),
            torch.full((1,), 3.0, dtype=tdt, device=dev)))
        vr = ray_lanes(150, 6, float(1200) ** (1 / 3), dt)
        for lab, b, sls in (
                ("self, box nodes", va, range(1, va.tree.levels + 1)),
                ("self, sphere nodes", vs, (1, 5)),
                ("self, box leaves", vb, (1, 6)),
                ("self, index_bits=64", v64, (1, 4))):
            for sl in sls:
                variants.append((f"W1 {lab}, start level {sl}{tag}",
                                 "walk_lanes", (b, sl, b.leaves),
                                 dict(dedup_ileaf=dedup_of(b)), sl == 1))
        for lab, q, t, flip in (
                ("two trees", va, vt, False),
                ("two trees flipped", vt, va, True),
                ("mixed, sphere lanes and box leaves", va, vtb, False),
                ("mixed, box lanes and sphere leaves", vb, vt, True),
                ("one-leaf lane tree", one, vt, True),
                ("one-leaf target tree", vt, one, False)):
            variants.append((f"W1 {lab}{tag}", "walk_lanes", (t, 1, q.leaves),
                             dict(flip=flip), lab == "two trees"))
        for lab, b in (("sphere leaves", va), ("box leaves", vb),
                       ("sphere nodes", vs), ("index_bits=64", v64)):
            variants.append((f"W1 rays, {lab}{tag}", "walk_lanes", (b, 1, vr),
                             dict(ray_offset=7), lab == "box leaves"))
        dfs_scenes = (("box nodes", scene(300, 7, dtype=dt)),
                      ("sphere nodes", scene(300, 8, node_kind=ib.BSphere,
                                             dtype=dt)),
                      ("box leaves", scene(300, 9, box=True, dtype=dt)),
                      ("index_bits=64", scene(300, 7, options=i64,
                                              dtype=dt)))
        for lab, b in dfs_scenes:
            for sl in (b.tree.levels // 2, b.tree.levels - 2):
                variants.append((f"W2 {lab}, start level {sl}{tag}",
                                 "dfs_lanes", (b, sl), {},
                                 sl == b.tree.levels // 2))
        if dt == np.float32:
            f32 = (va, vt, vb)
    # float64 lanes against float32 trees and the other way round: the
    # walk runs in float64, each sphere's box rounded in its own type
    for lab, q, t, flip in (
            ("float64 sphere lanes, float32 tree", va, f32[1], True),
            ("float32 sphere lanes, float64 tree", f32[0], vt, False),
            ("float32 box lanes, float64 sphere leaves", f32[2], vt, True)):
        variants.append((f"W1 mixed precisions, {lab}", "walk_lanes",
                         (t, 1, q.leaves), dict(flip=flip), True))
    n_checked = 0
    for label, name, args, kw, truncate in variants:
        wrapper, plain = kernels[name][:2]
        c, out0 = wrapper(*args, **kw)             # the count pass
        total = int(c.sum())
        off, _ = _scan(c)
        caps = (total + 3,) + ((max(total * 2 // 3, 1),) if truncate else ())
        for cap in caps:
            got = wrapper(*args, **kw, capacity=cap, offsets=off)
            pc, pout = plain(*args, **kw, capacity=cap, offsets=off)
            torch.cuda.synchronize()
            if not (torch.equal(c, pc) and torch.equal(got[0], pc) and
                    torch.equal(got[1], pout) and
                    torch.equal(off, _scan(pc)[0])):
                raise AssertionError(f"{label}: the kernel differs from its "
                                     f"plain version at capacity {cap}")
            n_checked += 1
        if total == 0 and "one-leaf" not in label:
            raise AssertionError(f"{label}: no contact, a weak check")
        log(f"{label}: {total} contacts, kernel == plain (counts, offsets "
            f"and the whole buffer in order at capacity "
            f"{' and '.join(map(str, caps))})")
    log(f"W1 and W2 equal their plain versions on {len(variants)} variants "
        f"({n_checked} buffers)")

    # b. the *_fixed walks and DFS's count -> scan -> write under the sync
    # check, then captured and replayed on new inputs (phase 22's cells)
    def sync_checked(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out

    def walk_summary(out):
        t, c = out
        t = int(t)
        c = c[:min(t, c.shape[0])].long()
        return t, ((c[:, 0] << 32) | c[:, 1]).sort().values

    g_self = ib.build(ray_spheres)
    moved_self = bvh_tensors(ib.build(ib.BSphere(
        torch.stack(ray_spheres.xs, 1) + displaced(N_RAY_TRIS, seed=7),
        ray_spheres.r)))
    cap_self = 1 << math.ceil(math.log2(keys_ray_self.numel()))
    dfs_sl = ib.default_start_level(g_self, ib.DFSTraversal())

    def self_check(label):
        def check(out):
            if not torch.equal(check_contacts(int(out[0]), out[1], 0,
                                              ray_spheres, label),
                               keys_ray_self):
                raise AssertionError(f"{label}: not the tile engine's set")
        return check

    def dfs_fixed():
        c, _ = dfs.dfs_single_fixed(g_self, dfs_sl)
        off, total = _scan(c)
        return total, dfs.dfs_single_fixed(g_self, dfs_sl, cap_self, off)[1]

    g_c4 = [ib.build(v) for v in c4]
    moved_c4 = bvh_tensors(ib.build(ib.BSphere(
        torch.stack(c4[1].xs, 1) + displaced(N_PAIR4[1], seed=8), c4[1].r)))

    def c4_check(out):
        if not torch.equal(pair_keys(out[0], out[1], 0, *N_PAIR4,
                                     "captured LVT pair"), keys_c4):
            raise AssertionError("traverse_lvt_pair_fixed: not config 4's "
                                 "set")

    g_wp, g_wd = wp.clone(), wd.clone()
    nrng = np.random.default_rng(9)
    new_rays = [torch.as_tensor((nrng.random((3, N_WALK_RAYS)) * wscale)
                                .astype(np.float32), device=dev),
                torch.as_tensor((nrng.random((3, N_WALK_RAYS)) - 0.5)
                                .astype(np.float32), device=dev)]
    keys_walk = hit_keys(tile_hits.num_contacts, tile_hits.cache1, 0,
                         N_RAY_TRIS, N_WALK_RAYS, "walk rays")

    def ray_check(out):
        if not torch.equal(hit_keys(out[0], out[1], 0, N_RAY_TRIS,
                                    N_WALK_RAYS, "captured ray walk"),
                           keys_walk):
            raise AssertionError("traverse_rays_fixed: not phase 14's set")

    for label, run, statics, fresh, check, name in (
            (f"traverse_lvt_single_fixed, {N_RAY_TRIS} leaves, capacity "
             f"{cap_self}", lambda: ib.traverse_lvt_single_fixed(
                 g_self, cap_self), bvh_tensors(g_self), moved_self,
             self_check("LVT self"), "walk_lanes"),
            (f"traverse_lvt_pair_fixed, config 4 ({N_PAIR4[0]} x "
             f"{N_PAIR4[1]} leaves)", lambda: ib.traverse_lvt_pair_fixed(
                 *g_c4, PAIR4_CAPACITY), bvh_tensors(g_c4[1]), moved_c4,
             c4_check, "walk_lanes"),
            (f"traverse_rays_fixed, {N_WALK_RAYS} rays x {N_RAY_TRIS} "
             "leaves", lambda: ib.traverse_rays_fixed(ray_bvh, g_wp, g_wd,
                                                      1 << 12),
             [g_wp, g_wd], new_rays, ray_check, "walk_lanes"),
            (f"DFS count -> scan -> write, {N_RAY_TRIS} leaves, start "
             f"level {dfs_sl}", dfs_fixed, bvh_tensors(g_self), moved_self,
             self_check("DFS"), "dfs_lanes")):
        ops.reset_launch_counts()
        check(sync_checked(run))
        log(f"{label}: no host sync, {launch_counts()[name]} launches of "
            f"{name}, the independent set")
        want_launches(graph_cell(label, run, statics, fresh, walk_summary,
                                 check, (name,)), (name,), label)
    del g_self, moved_self, g_c4, moved_c4, g_wp, g_wd, new_rays

    # c. times at phases 14 and 17's scenes, each pass's longest lane, and
    # the rows of the kernels line (write pass, beside its plain version)
    def test_flops(lane_kind, kind):
        """Float operations of one test of a lane (0 sphere, 1 box, 2 ray)
        against a volume of ``kind``; a box lane converts a sphere leaf per
        test, a sphere lane is converted once."""
        if lane_kind == 2:
            return FLOPS_PER_TEST["ray_box" if kind == 1 else "ray_sphere"]
        if lane_kind == kind == 0:
            return FLOPS_PER_TEST["sphere"]
        return FLOPS_PER_TEST["box"] + 6 * (lane_kind == 1 and kind == 0)

    # float32 bytes of one volume's own fields: a sphere (x, r), a box (lo,
    # up), a ray (p, d); the packed records pad a box or a ray to 32
    field_bytes = {0: 16, 1: 24, 2: 24}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def walk_shape(diag):
        """The work's shape from a diagnostic pass (``diag``, (K + 2, 4)):
        the longest lane and the longest single walk or item (the longest
        chain of dependent steps a thread ran), the steps of every lane,
        the SMs that ran one, the walks or items, those that ran on in
        place, and the blocks of the largest grid that ran one."""
        k = diag.shape[0] - 2
        tail = diag[k:].flatten().tolist()
        return {"longest_lane_steps": int(diag[:k, 0].max()),
                "longest_item_steps": int(diag[:k, 3].max()),
                "sum_steps": int(diag[:k, 0].long().sum()),
                "sms_used": sum(bin(w & 0xFFFFFFFF).count("1")
                                for w in tail[:5]),
                "items": tail[5], "in_place": tail[6],
                "grid_blocks": tail[7]}

    @contextlib.contextmanager
    def unsplit(name):
        """W1 in one stage (a thread a lane) or W2 in one round (each
        lane's item run to its end): the kernels without their split, to
        measure a step's latency on the longest lane."""
        saved = owalk.SPLIT_LANES, owalk.dfs_schedule
        owalk.SPLIT_LANES = 1
        owalk.dfs_schedule = lambda K, levels, sl: (owalk.DFS_BUDGET, 1, K)
        try:
            yield
        finally:
            owalk.SPLIT_LANES, owalk.dfs_schedule = saved

    def walk_row(row, name, call, n_launches, label, plain_too=True,
                 per_record=False):
        (args, kw) = call
        wrapper, plain, source, replaces = kernels[name]
        # the router passes the lanes positionally and the write pass's
        # capacity and offsets by keyword: the count pass drops those
        n_pos = 3 if name == "walk_lanes" else 2
        if len(args) != n_pos or kw.get("capacity", 0) <= 0:
            raise AssertionError(f"{row}: the recorded call is not a write "
                                 f"pass with its capacity by keyword")
        count_kw = {k: v for k, v in kw.items()
                    if k not in ("capacity", "offsets")}
        pack = owalk.pack_walk if name == "walk_lanes" else owalk.pack_dfs
        a = pack(*args, **kw)
        steps = []
        for pkw in (count_kw, kw):
            diag = torch.zeros((a.K + 2, 4), dtype=torch.int32, device=dev)
            c, out = wrapper(*args, **pkw, diag=diag)
            steps.append(walk_shape(diag))
        fixed = ("longest_lane_steps", "sum_steps")
        if any(steps[0][f] != steps[1][f] for f in fixed):
            raise AssertionError(f"{row}: the passes walked the lanes "
                                 f"differently: {steps}")
        shape = steps[1]
        tests = diag[:a.K].long().sum(0).tolist()
        c_ms = time_ms(lambda: wrapper(*args, **count_kw))
        k_ms = time_ms(lambda: wrapper(*args, **kw))
        d_ms = device_ms(lambda: wrapper(*args, **kw), device_kernel[name],
                         per_record=per_record)
        with unsplit(name):
            u_ms = time_ms(lambda: wrapper(*args, **count_kw))
            if not torch.equal(wrapper(*args, **count_kw)[0], c):
                raise AssertionError(f"{row}: the unsplit pass counts "
                                     "otherwise")
        p_ms = err = None
        if plain_too:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pc, pout = plain(*args, **kw)
            e1.record()
            e1.synchronize()
            p_ms = e0.elapsed_time(e1)
            err = max(int((c.long() - pc.long()).abs().max()),
                      int((out.long() - pout.long()).abs().max()))
            if err:
                raise AssertionError(f"{row}: the kernel differs from its "
                                     "plain version")
        total = int(c.sum())
        written = min(total, a.capacity)
        # each input once, the volumes by their own fields (a self walk's
        # lanes are its leaves), the index arrays, the counts and the rows
        node_kind = a.node_kind
        lane_kind = a.lane_kind if name == "walk_lanes" else node_kind
        vols = {a.nodes.data_ptr(): a.nodes.shape[0] * field_bytes[node_kind],
                a.leaves.data_ptr(): a.leaves.shape[0] *
                field_bytes[a.leaf_kind]}
        index = [a.leaf_index, a.skips, a.offsets]
        if name == "walk_lanes":
            vols[a.lanes.data_ptr()] = a.K * field_bytes[a.lane_kind]
            index += [a.lane_index, a.dedup]
        b = sum(vols.values()) + nbytes(*{
            t.data_ptr(): t for t in index if t is not None}.values()) + \
            nbytes(c) + 2 * written * c.element_size()
        ops_n = tests[1] * test_flops(lane_kind, node_kind) + \
            tests[2] * test_flops(
                lane_kind if name == "walk_lanes" else a.leaf_kind,
                a.leaf_kind)
        bytes_ms = b / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_n / FP32_OPS_PER_S * 1e3
        b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
            (ops_ms, "operations")
        step_us = u_ms * 1e3 / max(shape["longest_lane_steps"], 1)
        spread_ms = shape["sum_steps"] * step_us * 1e-3 / (sms * 2048)
        log(f"time: {row}, {label}: count pass {c_ms:.4f} ms, write pass "
            f"{k_ms:.4f} ms (CUDA events, median of 7; device "
            f"{fmt_ms(d_ms)}), plain write pass "
            f"{'not run' if p_ms is None else f'{p_ms:.1f} ms once'}; "
            f"{a.K} lanes, {total} contacts, {tests[1]} node and {tests[2]} "
            f"leaf tests; longest lane {shape['longest_lane_steps']} steps, "
            f"longest item {shape['longest_item_steps']} (a chain of as "
            f"many dependent record loads), {shape['items']} items "
            f"({shape['in_place']} ran on in place, grids of up to "
            f"{shape['grid_blocks']} blocks of 128 threads), "
            f"{shape['sum_steps']} steps in all, {shape['sms_used']} of "
            f"{sms} SMs ran one; unsplit (one thread a lane, or one round) "
            f"the count pass takes {u_ms:.4f} ms, {step_us:.4f} us a step "
            f"of the longest lane, at which the steps spread over every "
            f"thread of every SM would take {spread_ms:.6f} ms; launches "
            f"{n_launches}, bound {b_ms:.6f} ms ({b_by}; bytes "
            f"{bytes_ms:.6f}, operations {ops_ms:.6f}) [{card}]")
        if plain_too:
            rows.append({"name": row, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": n_launches,
                         "max_abs_err": err, "ms": k_ms, "device_ms": d_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_bytes_ms": bytes_ms,
                         "bound_operations_ms": ops_ms, "library_ms": None,
                         "count_pass_ms": c_ms, **shape,
                         "unsplit_count_pass_ms": u_ms, "step_us": step_us,
                         "spread_ms": spread_ms})

    for row, (call, n_launches) in walk_seen.items():
        walk_row(row, "walk_lanes", call, n_launches, "phase 14's scene")
    # the reference library's default algorithm at the bench scene: LVT
    # self-contact through W1 (a million lanes, one stage), phase 2's set
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with recorded_inputs() as seen:
        t0 = time.perf_counter()
        lvt_1m = ib.traverse(bvh, ib.LVTTraversal())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    n_launches = launch_counts()["walk_lanes"]
    if n_launches != 2 or not torch.equal(
            check_contacts(lvt_1m.num_contacts, lvt_1m.cache1, 0, spheres,
                           "LVT self at the bench scene"), keys_2p):
        raise AssertionError("LVT self-contact at the bench scene: not "
                             "phase 2's set, or W1 did not run its passes")
    log(f"time: walk (W1), traverse(bvh, LVTTraversal()) at the bench "
        f"scene ({N_BENCH} leaves): {sec:.3f} s once, "
        f"{lvt_1m.num_contacts} contacts (phase 2's set), {n_launches} "
        f"launches of walk_lanes [{card}]")
    del lvt_1m
    # the profiler kept 6 of the 7 write passes' records of this row in
    # every try (one kernel a call, one stage): the mean per kept record
    walk_row("walk_lanes[self, 1M]", "walk_lanes", seen["walk_lanes"],
             n_launches, "the bench scene", per_record=True)
    for k, (label, (call, n_launches)) in enumerate(dfs_seen.items()):
        # the plain loop at 1M would take minutes: that scene is timed
        # without it and gives no row
        walk_row("dfs_lanes[self]", "dfs_lanes", call, n_launches, label,
                 plain_too=k == 0)
    log(f"time: phase 23 (the walks on the device) "
        f"{time.perf_counter() - t23:.1f} s; the script "
        f"{time.perf_counter() - t_script:.1f} s")

    # 24. the tile engine in float64 (the kernels' <double> instantiation):
    # each kernel against its plain version on float64 inputs, the
    # full-width float64 scenes on both routes against independent float64
    # answers, the near-touching scene, the float64 step and pair query
    # captured, and B1-B4 and B6 timed in float64 beside their float32 rows
    t24 = time.perf_counter()

    def wide(tris_dev):
        """Triangles (as ``to_dev`` gives them) in float64."""
        return tuple(tuple(c.double() for c in tri) for tri in tris_dev)

    def f64_path(run, route, label):
        """A float64 ``*_fixed`` call under the sync check with its launch
        counts, which must be its route's."""
        out, launches = counted(run)
        check_pair_launches(launches, route, label)
        return out, launches

    # a. the small scenes of phases 1, 6 and 11 in float64
    small64 = wide(small)
    tile32_2p = ib.TileTraversal(tile=32, **TWO_PHASE)
    with recorded_inputs() as seen:
        _, small64_bvh, _ = step(*small64, 4096, tile32_2p)
    label = f"small scene in float64 ({N_SMALL} triangles, tile 32"
    check_kernels(seen, label + ", two-phase)", two_phase_kernels)
    with recorded_inputs() as seen:
        ib.traverse_tiles_fixed(small64_bvh, 4096, alg=ib.TileTraversal(
            tile=32, decode_k=8, **TWO_PHASE))
    check_kernels(seen, label + ", two-phase with decode_k=8)",
                  ("tile_run_counts",))
    with recorded_inputs() as seen:
        step(*small64, 4096, small_fb)
    check_kernels(seen, label + ", fallback)", fallback_kernels)
    check_kernel("tile_pair_contacts", *pair_list(small64_bvh, small_fb),
                 label + ", fallback)")
    sph64 = ib.bsphere_from_triangles(*small64)
    box64 = ib.BBox(tuple(torch.round(x - sph64.r) for x in sph64.xs),
                    tuple(torch.round(x + sph64.r) + 0.5 for x in sph64.xs))
    for kind, vol in (("sphere", sph64), ("box", box64)):
        seen = record_ray_inputs(
            ib.build(vol), sp.double(), sd.double(), 1 << 15,
            ib.TileTraversal(decode_k=8, **ray_small),
            ib.TileTraversal(tile=32, row_cap=16, pair_cap=256),
            emit_alg=ib.TileTraversal(**ray_small))
        check_ray_kernels(seen, f"small ray scene in float64 ({N_SMALL} "
                          f"{kind} leaves, 1024 rays, tile 32)")
    sph64_2 = ib.bsphere_from_triangles(
        *wide(to_dev(synth_triangles(N_SMALL // 2, seed=2), dev)))
    for kind, v1, v2 in (("sphere", sph64, sph64_2),
                         ("box", boxes_of(sph64), boxes_of(sph64_2))):
        b1, b2 = ib.build(v1), ib.build(v2)
        label = (f"small pair scene in float64 ({N_SMALL} x {N_SMALL // 2} "
                 f"{kind} leaves, tile 32")
        bf = brute_force_pair_keys(v1, v2)
        for route, alg, names in (("two-phase", tile32_2p, two_phase_kernels),
                                  ("fallback", small_fb, fallback_kernels)):
            with recorded_inputs() as seen:
                out = ib.traverse_tiles_pair_fixed(b1, b2, 8192, alg=alg)
            check_kernels(seen, f"{label}, {route})", names, pair=True)
            if not torch.equal(pair_keys(*out[:3], N_SMALL, N_SMALL // 2,
                                         f"{label}, {route})"), bf):
                raise AssertionError(f"{label}, {route}): the pair set "
                                     "differs from the brute force's")
    del small64_bvh, sph64, box64, sph64_2, b1, b2

    # b. the bench scene from its triangles in float64, both routes: its
    # set is the float64 W1 walk's, and the kernels equal their plain
    # versions at its inputs
    tris64 = wide(tris)
    spheres64 = ib.bsphere_from_triangles(*tris64)
    bvh64f = ib.build(spheres64)
    keys_of = {}
    launches_f64 = {}
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        label = f"bench scene in float64, {route}"
        (t, c, o, nc), launches_f64[route] = f64_path(
            lambda: ib.traverse_tiles_fixed(bvh64f, capacity, alg=alg),
            route, label)
        keys_of[route] = check_contacts(int(t), c, int(o), spheres64, label)
        log(f"{label}: {N_BENCH} triangles, {int(t)} contacts (float32: "
            f"{TPU_BENCH_CONTACTS}), overflow 0, no duplicates, no host "
            f"sync, num_checks {float(nc):.0f}, launches "
            f"{launches_f64[route]}")
    keys_f64 = keys_of["two-phase"]
    lvt64 = ib.traverse(bvh64f, ib.LVTTraversal())
    if not torch.equal(keys_of["fallback"], keys_f64) or not torch.equal(
            check_contacts(lvt64.num_contacts, lvt64.cache1, 0, spheres64,
                           "float64 W1 walk at the bench scene"), keys_f64):
        raise AssertionError("bench scene in float64: the routes' sets and "
                             "the float64 W1 walk's differ")
    n32_only = int((~torch.isin(keys_2p, keys_f64)).sum())
    n64_only = int((~torch.isin(keys_f64, keys_2p)).sum())
    log(f"bench scene in float64: both routes give the float64 W1 walk's "
        f"{keys_f64.numel()} contacts; {n64_only} of them are not in the "
        f"float32 set, {n32_only} float32 contacts are not in it")
    del lvt64, c
    with recorded_inputs() as seen_f64:
        ib.traverse_tiles_fixed(bvh64f, capacity, alg=two_phase)
    check_kernels(seen_f64, f"bench scene in float64 ({N_BENCH} triangles, "
                  "two-phase)", two_phase_kernels)
    with recorded_inputs() as seen_f64_fb:
        ib.traverse_tiles_fixed(bvh64f, capacity, alg=fallback)
    label = f"bench scene in float64 ({N_BENCH} triangles, fallback)"
    check_kernels(seen_f64_fb, label, fallback_kernels)
    b6_in64 = pair_list(bvh64f, fallback)
    check_kernel("tile_pair_contacts", *b6_in64, label)

    # c. the 249,882-triangle reference scene in float64 against the brute
    # force over all sphere pairs
    d_sph64 = ib.bsphere_from_triangles(
        *wide(to_dev(synth_triangles(N_DRAGON, seed=0), dev)))
    d_bvh64 = ib.build(d_sph64)
    t0 = time.perf_counter()
    keys_d64 = brute_force_self_keys(d_sph64)
    log(f"reference scene in float64: brute force of "
        f"{N_DRAGON * (N_DRAGON - 1) // 2} sphere pairs on the card, "
        f"{keys_d64.numel()} contacts (float32: {TPU_DRAGON_CONTACTS}), "
        f"{time.perf_counter() - t0:.3f} s")
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        label = f"reference scene in float64, {route}"
        (t, c, o, _), launches = f64_path(
            lambda: ib.traverse_tiles_fixed(d_bvh64, DRAGON_CAPACITY,
                                            alg=alg), route, label)
        if not torch.equal(check_contacts(int(t), c, int(o), d_sph64, label),
                           keys_d64):
            raise AssertionError(f"{label}: not the brute force's set")
        log(f"{label}: {int(t)} contacts, the brute force's set, overflow "
            f"0, no duplicates, no host sync, launches {launches}")
    del d_sph64, d_bvh64, c

    # d. the full-width ray scene in float64 against brute_force_keys
    ray_sph64 = ib.bsphere_from_triangles(
        *wide(to_dev(synth_triangles(N_RAY_TRIS), dev)))
    ray_bvh64f = ib.build(ray_sph64)
    rp64, rd64 = rp.double(), rd.double()
    t0 = time.perf_counter()
    keys_r64 = brute_force_keys(ray_sph64, rp64, rd64)
    log(f"ray scene in float64: brute force of {N_RAYS} x {N_RAY_TRIS} tests "
        f"on the card, {keys_r64.numel()} hits (float32: {TPU_RAY_HITS}), "
        f"{time.perf_counter() - t0:.3f} s")
    for route, alg, names, none in (
            ("two-phase", None, ray_two_phase_kernels, ray_fallback_kernels),
            ("fallback", ray_fallback, ray_fallback_kernels,
             ray_two_phase_kernels)):
        label = f"ray scene in float64, {route}"
        (t, c, o, _), launches = ray_path(ray_bvh64f, rp64, rd64,
                                          RAY_CAPACITY, alg)
        if min(launches[n] for n in names) < 1 or \
                any(launches[n] for n in none):
            raise AssertionError(f"{label}: launches are wrong: {launches}")
        if not torch.equal(hit_keys(t, c, o, N_RAY_TRIS, N_RAYS, label),
                           keys_r64):
            raise AssertionError(f"{label}: not the brute force's hits")
        log(f"{label}: {int(t)} hits, the brute force's set, overflow 0, "
            f"no duplicates, no host sync, launches {launches}")
    seen = record_ray_inputs(ray_bvh64f, rp64, rd64, RAY_CAPACITY, None,
                             ray_fallback)
    check_ray_kernels(seen, f"ray scene in float64 ({N_RAY_TRIS} leaves, "
                      f"{N_RAYS} rays)")
    del ray_sph64, ray_bvh64f, c, keys_r64

    # e. config 4's pair scene in float64 against brute_force_pair_keys
    c4_64 = [ib.bsphere_from_triangles(*wide(to_dev(
        synth_triangles(n, seed=sd_), dev)))
        for n, sd_ in ((N_PAIR4[0], 2), (N_PAIR4[1], 3))]
    keys_c4_64 = brute_force_pair_keys(*c4_64)
    c4_bvh_64 = [ib.build(v) for v in c4_64]
    for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
        label = f"config 4 scene in float64, {route}"
        (t, c, o, _), launches = f64_path(
            lambda: ib.traverse_tiles_pair_fixed(*c4_bvh_64, PAIR4_CAPACITY,
                                                 alg=alg), route, label)
        if not torch.equal(pair_keys(t, c, o, *N_PAIR4, label), keys_c4_64):
            raise AssertionError(f"{label}: not the brute force's set")
        log(f"{label}: {int(t)} contacts (float32: {TPU_PAIR4_CONTACTS}), "
            f"the brute force's set, overflow 0, no duplicates, no host "
            f"sync, launches {launches}")
    del c4_64, c4_bvh_64, c

    # f. the full-width pair scene in float64, and the mixed pair (the
    # float32 bench BVH against the float64 second body): each route's
    # set is the float64 W1 walk's
    body2_64 = ib.bsphere_from_triangles(
        *wide(to_dev(synth_triangles(N_BODY2, seed=3), dev)))
    bvh2_64 = ib.build(body2_64)
    keys_pair64 = None
    for name, b1 in (("float64", bvh64f), ("mixed float32 x float64", bvh)):
        walk = ib.traverse(b1, bvh2_64, ib.LVTTraversal())
        want = pair_keys(walk.num_contacts, walk.cache1, 0, N_BENCH,
                         N_BODY2, f"pair scene, {name}, W1")
        del walk
        seen_p = {}
        for route, alg in (("two-phase", two_phase), ("fallback", fallback)):
            label = f"pair scene, {name}, {route}"
            (t, c, o, _), launches = f64_path(
                lambda: ib.traverse_tiles_pair_fixed(
                    b1, bvh2_64, PAIR_CAPACITY, alg=alg,
                    pair_capacity=PAIR_PAIR_CAPACITY), route, label)
            if not torch.equal(pair_keys(t, c, o, N_BENCH, N_BODY2, label),
                               want):
                raise AssertionError(f"{label}: not the float64 W1 walk's "
                                     "set")
            log(f"{label}: {N_BENCH} x {N_BODY2} leaves, {int(t)} contacts "
                f"(float32: {keys_union.numel()}), the float64 W1 walk's "
                f"set, overflow 0, no duplicates, no host sync, launches "
                f"{launches}")
            with recorded_inputs() as seen_p[route]:
                ib.traverse_tiles_pair_fixed(
                    b1, bvh2_64, PAIR_CAPACITY, alg=alg,
                    pair_capacity=PAIR_PAIR_CAPACITY)
        if keys_pair64 is None:
            keys_pair64 = want
            check_kernels(seen_p["two-phase"], f"pair scene in float64 "
                          "(two-phase)", two_phase_kernels, pair=True)
            check_kernels(seen_p["fallback"], f"pair scene in float64 "
                          "(fallback)", fallback_kernels, pair=True)
        del seen_p, c

    # g. the near-touching scene: 500 pairs of spheres of radius 0.01 whose
    # centres lie 2r(1 + 1e-10) apart, one pair per cell of a unit lattice:
    # apart in float64, and the float32 brute force's contacts once rounded
    rng = np.random.default_rng(7)
    n_near = 500
    cell = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n_near].astype(np.float64)
    cen = cell + 0.25 + rng.random((n_near, 3)) * 0.5
    u = rng.normal(size=(n_near, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    near_x = np.concatenate([cen, cen + u * (2 * 0.01 * (1 + 1e-10))])
    near_r = np.full(2 * n_near, 0.01)
    for dt in (np.float64, np.float32):
        near = ib.BSphere(near_x.astype(dt), near_r.astype(dt), device=dev)
        near_bvh = ib.build(near)
        want = brute_force_self_keys(near)
        # in float32 a tile pair holds more contacts than TWO_PHASE's caps
        for route, alg in (("two-phase", ib.TileTraversal(row_cap=8,
                                                          pair_cap=128)),
                           ("fallback", fallback)):
            label = f"near-touching scene in {np.dtype(dt).name}, {route}"
            (t, c, o, _), launches = f64_path(
                lambda: ib.traverse_tiles_fixed(near_bvh, 4096, alg=alg),
                route, label)
            keys = check_contacts(int(t), c, int(o), near, label)
            if not torch.equal(keys, want) or \
                    (dt == np.float64) != (int(t) == 0):
                raise AssertionError(f"{label}: {int(t)} contacts, not the "
                                     f"brute force's {want.numel()}")
            log(f"{label}: {int(t)} contacts of {n_near} pairs 2r(1 + 1e-10) "
                f"apart, the {np.dtype(dt).name} brute force's set, "
                f"launches {launches}")
    del near, near_bvh

    # h. the float64 bench step and pair query captured in CUDA graphs and
    # replayed on new inputs (phase 22's cells)
    g_tris64 = [p.clone() for tri in tris64 for p in tri]
    new_tris64 = [p for tri in wide(to_dev(synth_triangles(N_BENCH, seed=4),
                                           dev)) for p in tri]

    def bench64_captured(out):
        t, c, o, _ = out
        if not torch.equal(check_contacts(int(t), c, int(o), spheres64,
                                          "float64 step"), keys_f64):
            raise AssertionError("float64 bench step graph: not the "
                                 "float64 set")

    launches = graph_cell(
        "bench step in float64, two-phase",
        lambda: step(*[g_tris64[3 * k:3 * k + 3] for k in range(3)],
                     capacity, two_phase)[2],
        g_tris64, new_tris64, pair_summary, bench64_captured,
        two_phase_kernels)
    check_pair_launches(launches, "two-phase", "float64 bench step graph")
    del g_tris64, new_tris64
    g_b1, g_b2 = ib.build(spheres64), ib.build(body2_64)
    moved2 = ib.build(ib.BSphere(torch.stack(body2_64.xs, 1) +
                                 displaced(N_BODY2).double(), body2_64.r))

    def pair64_captured(out):
        t, c, o, _ = out
        if not torch.equal(pair_keys(t, c, o, N_BENCH, N_BODY2,
                                     "float64 pair graph"), keys_pair64):
            raise AssertionError("float64 pair graph: not the float64 set")

    launches = graph_cell(
        "pair query in float64, two-phase",
        lambda: ib.traverse_tiles_pair_fixed(
            g_b1, g_b2, PAIR_CAPACITY, alg=two_phase,
            pair_capacity=PAIR_PAIR_CAPACITY),
        bvh_tensors(g_b2), bvh_tensors(moved2), pair_summary,
        pair64_captured, two_phase_kernels)
    check_pair_launches(launches, "two-phase", "float64 pair graph")
    del g_b1, g_b2, moved2, body2_64, bvh2_64

    # i. B1-B4 and B6 in float64 at the bench scene's inputs beside their
    # float32 rows, in turns (float32, float64, float64, float32)
    inputs64 = {n: seen_f64[n] for n in two_phase_kernels}
    inputs64["tile_group_contacts"] = seen_f64_fb["tile_group_contacts"]
    inputs64["tile_pair_contacts"] = b6_in64
    launches64 = dict(launches_f64["fallback"])
    launches64.update({n: launches_f64["two-phase"][n]
                       for n in two_phase_kernels})
    for name, (args, kw) in inputs64.items():
        wrapper, plain, source, replaces = kernels[name]
        args32, kw32 = inputs[name]
        turns = {"float32": [], "float64": []}
        for dt in ("float32", "float64", "float64", "float32"):
            a, k = (args32, kw32) if dt == "float32" else (args, kw)
            turns[dt].append(time_ms(lambda: wrapper(*a, **k)))
        # each of the wrapper's kernels runs once a call; the profiler this
        # late in the script keeps only some of their records
        d32 = device_ms(lambda: wrapper(*args32, **kw32), device_kernel[name],
                        per_record=True)
        d64 = device_ms(lambda: wrapper(*args, **kw), device_kernel[name],
                        per_record=True)
        p_ms = time_ms(lambda: plain(*args, **kw), reps=3)
        bytes_ms, ops_ms = bound(name, args, kw)
        b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
            (ops_ms, "operations")
        row = row_of(name, kw, f64=True)
        k_ms = statistics.median(turns["float64"])
        ratio = (f"{d64 / d32:.2f}x" if d32 and d64 else "not measured")
        log(f"time: {row} kernel {turns['float64'][0]:.4f} / "
            f"{turns['float64'][1]:.4f} ms beside {row_of(name, kw32)} "
            f"{turns['float32'][0]:.4f} / {turns['float32'][1]:.4f} ms (in "
            f"turns, CUDA events, median of 7 each); device {fmt_ms(d64)} "
            f"against {fmt_ms(d32)} ({ratio}); plain {p_ms:.4f} ms, "
            f"launches {launches64.get(name, 0)}, bound {b_ms:.6f} ms "
            f"({b_by}; bytes {bytes_ms:.6f}, operations {ops_ms:.6f} at "
            f"{FP64_OPS_PER_S / 1e12:.0f} TFLOP/s) [{card}]")
        rows.append({"name": row, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches64.get(name, 0),
                     "max_abs_err": errs[row], "ms": k_ms, "device_ms": d64,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_bytes_ms": bytes_ms,
                     "bound_operations_ms": ops_ms, "library_ms": None,
                     "float32_ms": statistics.median(turns["float32"]),
                     "float32_device_ms": d32})
    del spheres64, bvh64f, tris64, seen_f64, seen_f64_fb, b6_in64, inputs64
    log(f"time: phase 24 (the tile engine in float64) "
        f"{time.perf_counter() - t24:.1f} s; the script "
        f"{time.perf_counter() - t_script:.1f} s")

    # 25. R1 at the dragon-rays cell's shape: 100,000 rays against the
    # leaf tiles of the 249,882-triangle scene at the ray defaults (tile
    # 128, 4 bands: RT 782, T 1,953), in float32 and float64: kernel ==
    # plain, the eager and device times beside the operations bound and the
    # plain version's time
    t25 = time.perf_counter()
    from implicitbvh_tpu_torch.raytrace import _prep_rays
    d_bvh = ib.build(ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_DRAGON, seed=0), dev)))
    dp, dd = _prep_rays(*bench_rays(N_DRAGON), torch.float32, dev)
    G, NB = ray_tiles.RAY_ALG.tile, ray_tiles.RAY_ALG.bands
    rf32, RT = ray_tiles._ray_tile_fields(dp, dd,
                                          ray_tiles._sort_rays(dp, dd), G)
    tl32 = tiles._tiled_fields(d_bvh, G)[2]
    T = tl32.shape[1]
    n_tests = RT * G * T
    for f64 in (False, True):
        dt = torch.float64 if f64 else torch.float32
        rf, tl = rf32.to(dt), tl32.to(dt)
        name = "ray_band_bits"
        wrapper, plain, source, replaces = kernels[name]
        row = row_of(name, {}, f64=f64)
        ops.reset_launch_counts()
        got = wrapper(rf, tl, NB)
        n_launches = launch_counts()[name]
        want = plain(rf, tl, NB)
        torch.cuda.synchronize()
        if n_launches != 1 or not torch.equal(got, want):
            raise AssertionError(f"{row} at the dragon-rays shape differs "
                                 "from its plain version")
        errs.setdefault(row, 0)
        k_ms = time_ms(lambda: wrapper(rf, tl, NB))
        d_ms = device_ms(lambda: wrapper(rf, tl, NB), device_kernel[name],
                         per_record=True)
        p_ms = time_ms(lambda: plain(rf, tl, NB), reps=3)
        bytes_ms = nbytes(rf, tl, got) / HBM_BYTES_PER_S * 1e3
        ops_ms = n_tests * R1_INSTR_PER_TEST / (
            (FP64_OPS_PER_S if f64 else FP32_OPS_PER_S) / 2) * 1e3
        b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
            (ops_ms, "operations")
        log(f"time: {row} at the dragon-rays shape (RT {RT}, G {G}, NB "
            f"{NB}, T {T}: {n_tests} slab tests, {int((got > 0).sum())} "
            f"live words): kernel {k_ms:.4f} ms, device {fmt_ms(d_ms)}, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; bytes "
            f"{bytes_ms:.6f}, operations {ops_ms:.6f}: "
            f"{R1_INSTR_PER_TEST} instructions a test at the non-FMA "
            f"issue rate); kernel == plain (exact) [{card}]")
        rows.append({"name": row, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n_launches,
                     "max_abs_err": errs[row], "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_bytes_ms": bytes_ms,
                     "bound_operations_ms": ops_ms, "library_ms": None})
        del rf, tl, got, want
    del d_bvh, dp, dd, rf32, tl32
    log(f"time: phase 25 (R1 at the dragon-rays shape) "
        f"{time.perf_counter() - t25:.1f} s; the script "
        f"{time.perf_counter() - t_script:.1f} s")

    # 26. L1 at the inputs the tile cells' paths give it: every call of
    # leader_group in a self query, a two-tree query and a ray query at the
    # cells' capacities, kernel == plain, timed beside its bytes bound, the
    # plain chain and a lone torch.cummax of the same length
    t26 = time.perf_counter()
    calls = []

    def recorder(ti, valid, payloads, pads, W, S_cap):
        calls.append((ti, valid, tuple(payloads), pads, W, S_cap))
        return ops.leader_group(ti, valid, payloads, pads, W, S_cap)

    l1_bvh = ib.build(ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_BENCH), dev)))
    tool = ib.build(ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_DRAGON, seed=3), dev)))
    r_bvh = ib.build(ib.bsphere_from_triangles(
        *to_dev(synth_triangles(N_DRAGON, seed=0), dev)))
    rp, rd = bench_rays(N_DRAGON)
    queries = (
        ("particles", lambda: ib.traverse_tiles_fixed(
            l1_bvh, 131072, alg=ib.TileTraversal(row_cap=4, pair_cap=32),
            pair_capacity=294912), ("runs", "regroup")),
        ("two_body", lambda: ib.traverse_tiles_pair_fixed(
            l1_bvh, tool, 144384,
            alg=ib.TileTraversal(row_cap=16, pair_cap=128),
            pair_capacity=188416), ("runs", "regroup")),
        ("rays", lambda: ib.traverse_rays_tiles_fixed(
            r_bvh, rp, rd, 524288), ("regroup",)))
    saved = tiles.leader_group
    tiles.leader_group = recorder
    try:
        # each query's own launches of L1, read from its run: two in a self
        # or two-tree query (the run lists and the emit regroup), one in a
        # ray tile run (the regroup)
        recorded = []
        for cell, query, stages in queries:
            calls.clear()
            ops.reset_launch_counts()
            query()
            torch.cuda.synchronize()
            path_launches = ops.launch_count(ops.leader_group)
            if len(calls) != len(stages) or path_launches != len(stages):
                raise AssertionError(
                    f"L1: the {cell} query called leader_group {len(calls)} "
                    f"times and launched it {path_launches} times, not "
                    f"{len(stages)}")
            log(f"L1: the {cell} query launched leader_group "
                f"{path_launches} times ({', '.join(stages)})")
            recorded += [(f"{cell}_{st}", a, path_launches)
                         for st, a in zip(stages, calls)]
    finally:
        tiles.leader_group = saved
    for label, args, path_launches in recorded:
        ti, valid, payloads, pads, W, S_cap = args
        E, k = ti.shape[0], len(payloads)
        row = f"leader_group[{label}]"
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ops.leader_group(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = ops.leader_group_plain(*args)
        torch.cuda.synchronize()
        same = (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                and all(torch.equal(x, y) for x, y in zip(got[1], want[1])))
        if not same:
            raise AssertionError(f"{row} differs from its plain version")
        v = valid.int()
        cv_ex = torch.cumsum(v, 0) - v
        prev = torch.cat([ti.new_full((1,), -1), ti[:-1]])
        scan_in = torch.where(ti != prev, cv_ex, -1)    # the chain's cummax
        k_ms = time_ms(lambda: ops.leader_group(*args))
        d_ms = device_ms(lambda: ops.leader_group(*args),
                         ("leader_tile_kernel", "leader_scan_kernel"),
                         per_record=True)
        p_ms = time_ms(lambda: ops.leader_group_plain(*args))
        lib_ms = time_ms(lambda: torch.cummax(scan_in, 0))
        lib_dms = device_ms(lambda: torch.cummax(scan_in, 0),
                            ("scan_innermost_dim_with_indices",))
        n_bytes = nbytes(ti, valid, *got[1]) + E * sum(
            p.element_size() for p in payloads) + 4 * (S_cap + 1)
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"time: {row} (E {E}, k {k}, W {W}, S_cap {S_cap}, "
            f"{int(valid.sum())} valid, nsteps {int(got[2])}): kernel "
            f"{k_ms:.4f} ms, device {fmt_ms(d_ms)}, bound {b_ms:.6f} ms "
            f"(bytes: {n_bytes}), plain chain {p_ms:.4f} ms, torch.cummax "
            f"alone {lib_ms:.4f} ms (device {fmt_ms(lib_dms)}); kernel == "
            f"plain (exact), no host sync [{card}]")
        rows.append({"name": row, "route": "cuda",
                     "source": "implicitbvh_tpu_torch/csrc/leader_group.cu",
                     "replaces": "none: jax.lax.cummax glue in "
                                 "implicitbvh_tpu/traverse/tiles.py:346",
                     "launches": path_launches, "max_abs_err": 0,
                     "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": "bytes", "bound_bytes_ms": b_ms,
                     "bound_operations_ms": 0.0, "library_ms": lib_ms})
        del got, want, scan_in
    del l1_bvh, tool, r_bvh, rp, rd, recorded, calls
    log(f"time: phase 26 (L1 at the tile cells' shapes) "
        f"{time.perf_counter() - t26:.1f} s; the script "
        f"{time.perf_counter() - t_script:.1f} s")

    # 27. T1, the build, at 2^20 spheres (the bench scene's) and at the
    # 249,882 of the dragon cells: kernel == plain bit for bit under the sync
    # check, times beside its bytes bound, the plain chain and a lone
    # torch.sort of the chain's int64 keys; then every build of the three
    # graph cells' steps (their step drivers' warm-up and capture at the
    # cells' sizes) goes through T1: launches.tree_build == calls.build
    t27 = time.perf_counter()
    import importlib
    t1m = importlib.import_module("implicitbvh_tpu_torch.ops.tree_build")
    t1_names = ("extrema_kernel", "codes_kernel", "leaves_kernel",
                "top_kernel")
    opts = ib.BVHOptions()
    for label, n_tri, seed in (("2^20", N_BENCH, 0), ("249882", N_DRAGON,
                                                       0)):
        sph = ib.bsphere_from_triangles(*to_dev(synth_triangles(n_tri, seed),
                                                dev))
        tree = ib.ImplicitTree.from_num_leaves(n_tri)

        def t1_build():
            return ops.tree_build(sph, None, tree, 1, ib.BBox, opts)

        def plain_build():
            return t1m.tree_build_plain(sph, None, tree, 1, ib.BBox, opts)

        row = f"tree_build[{label}]"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = t1_build()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n_launches = ops.launch_count(ops.tree_build)
        want = plain_build()
        torch.cuda.synchronize()
        flat = lambda o: (*t1m._fields(o[0]), o[1], o[2],
                          *t1m._fields(o[3]), o[4])
        if n_launches != 1 or any(
                a.dtype != b.dtype or not torch.equal(
                    a.view(torch.int32) if a.dtype == torch.float32 else a,
                    b.view(torch.int32) if b.dtype == torch.float32 else b)
                for a, b in zip(flat(got), flat(want), strict=True)):
            raise AssertionError(f"{row} differs from its plain version")
        codes = ib.morton_encode(sph.xs, opts.morton)
        key64 = codes ^ (-1 << 63)              # the chain's sort key
        k_ms = time_ms(t1_build)
        d_ms = device_ms(t1_build, t1_names, per_record=True)
        sort_dms = device_ms(lambda: torch.sort(codes.int(), stable=True),
                             ("RadixSort",))
        p_ms = time_ms(plain_build)
        lib_ms = time_ms(lambda: torch.sort(key64, stable=True))
        n = n_tri
        # T1a reads the centres; T1b the four fields, and writes int32 keys
        # and 16-byte records; T1c reads the sorted keys, the permutation
        # and the records, and writes the fields sorted with an int32 index
        # and an int64 code, and the nodes
        n_bytes = 4 * 3 * n + (16 + 4 + 16) * n + (4 + 8 + 16) * n + \
            (16 + 4 + 8) * n + 4 * 6 * tree.num_nodes
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"time: {row} ({n} sphere leaves, {tree.levels} levels, K "
            f"{t1m.tile_log2(torch.float32, tree)}): T1 build {k_ms:.4f} ms "
            f"(the sort included), T1's four kernels on the device "
            f"{fmt_ms(d_ms)}, the int32 sort's kernels {fmt_ms(sort_dms)}, "
            f"bound {b_ms:.6f} ms (bytes: {n_bytes}), plain chain "
            f"{p_ms:.4f} ms, torch.sort of the int64 keys alone "
            f"{lib_ms:.4f} ms; T1 == plain (exact), no host sync [{card}]")
        rows.append({"name": row, "route": "cuda",
                     "source": "implicitbvh_tpu_torch/csrc/tree_build.cu",
                     "replaces": "none: XLA ops in implicitbvh_tpu/build.py",
                     "launches": n_launches, "max_abs_err": 0, "ms": k_ms,
                     "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": "bytes", "bound_bytes_ms": b_ms,
                     "bound_operations_ms": 0.0, "library_ms": lib_ms})
        del sph, got, want, codes, key64
    import portbench.harness as pb
    for cell_name in ("particles1m-step-graph", "dragon-lvt-graph",
                      "bed1m-tool250k-pair-graph"):
        cell = pb.load_cell(cell_name)
        cell.traffic["warmup"] = 1
        if "settle_s" in cell.traffic:
            cell.traffic["settle_s"] = 0
        tracing.reset()
        drv = pb.step_driver(cell.traffic)(cell.config, cell.traffic,
                                           2 ** 31 + 27, dev, False)
        drv.setup()
        drv.run(0)
        torch.cuda.synchronize()
        c = tracing.counters()
        n_builds, n_t1 = c.get("calls.build", 0), c.get(
            "launches.tree_build", 0)
        if n_builds < 1 or n_t1 != n_builds:
            raise AssertionError(f"{cell_name}: {n_builds} builds, "
                                 f"{n_t1} of them through T1")
        log(f"{cell_name}: every build of its step's warm-up and capture "
            f"went through T1 ({n_t1} of {n_builds})")
        del drv
        torch.cuda.empty_cache()
    log(f"time: phase 27 (T1, the build) {time.perf_counter() - t27:.1f} s; "
        f"the script {time.perf_counter() - t_script:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
