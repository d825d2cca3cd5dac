"""The program's spans and counters (``implicitbvh_tpu_torch.tracing``):
off records nothing and keeps nothing while the counters count; spans
nest under one call id per public call, on the profiler's clock, and add
no record to the profiler's; the growth loop's and the host syncs'
counters against what a call did; and (``gpu``) device intervals on the
card and a graph captured with tracing on or off.  No JAX: the ``gpu``
cases run on the card with ``--noconftest``."""

import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import tracing
from implicitbvh_tpu_torch.traverse import walk as twalk

TILE_STAGES = {"tiles.fields", "tiles.phase1", "tiles.count",
               "tiles.regroup", "tiles.emit", "tiles.merge", "tiles.finish"}
FALLBACK_STAGES = {"tiles.fields", "tiles.phase1", "tiles.emit",
                   "tiles.finish"}
RAY_STAGES = {"rays.sort", "rays.phase1", "rays.count", "rays.regroup",
              "rays.emit", "rays.merge", "rays.finish"}
BUILD_STAGES = {"build.morton", "build.sort", "build.nodes"}


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def particles(n: int, side: float, r: float = 0.5, seed: int = 0,
              device="cpu"):
    """``n`` spheres of radius ``r`` uniform in a cube of ``side``."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(3, n, generator=g) * side).to(device)
    return tb.BSphere(tuple(x), torch.full((n,), r, device=device))


def rays(n: int, side: float, seed: int = 1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(3, n, generator=g) * side
    d = torch.randn(3, n, generator=g)
    return p.to(device), d.to(device)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_no_span_and_the_counters_count(monkeypatch):
    made = []

    class Counted(tracing.Span):
        __slots__ = ()

        def __init__(self, *args):
            made.append(args[0])
            super().__init__(*args)

    def no_cuda(*args, **kw):
        raise AssertionError("a CUDA call with tracing off")

    monkeypatch.setattr(tracing, "Span", Counted)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    assert not tracing.is_on()
    bvh = tb.build(particles(3000, 14.0))
    res = tb.traverse(bvh, tb.TileTraversal(tile=32))
    tb.traverse(bvh, tb.TileTraversal(tile=32), cache=res)
    assert made == [] and tracing.snapshot()["spans"] == []
    c = tracing.counters()
    assert c["calls.build"] == 1 and c["calls.traverse"] == 2
    assert c["grow.runs"] >= 2 and c["syncs"] >= 6
    # one shared null context, false, for every device; nothing kept
    assert tracing.span("a") is tracing.span("b", torch.device("cuda"))
    with tracing.span("a", torch.device("cuda")) as s:
        assert not s
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with tracing.span("a", torch.device("cuda")):
                pass
        kept = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert kept < 1024 and made == []


def test_spans_nest_under_one_call_id_per_public_call():
    p, d = rays(300, 14.0)
    with tracing.enabled():
        assert tracing.is_on()
        bvh = tb.build(particles(3000, 14.0))
        res = tb.traverse(bvh, tb.TileTraversal(tile=32))
        hits = tb.traverse_rays(bvh, p, d)
    assert not tracing.is_on()
    assert res.num_contacts > 0 and hits.num_contacts > 0
    spans = tracing.snapshot()["spans"]
    ids = {s["id"]: s for s in spans}
    roots = sorted((s for s in spans if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    assert [s["name"] for s in roots] == ["build", "traverse", "traverse"]
    assert len({s["call"] for s in roots}) == 3
    for s in spans:
        if s["parent"] is None:
            continue
        up = ids[s["parent"]]
        assert up["call"] == s["call"]
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
            up["end_ns"]
    calls = [by_name(s for s in spans if s["call"] == r["call"])
             for r in roots]
    assert set(calls[0]) == {"build"} | BUILD_STAGES
    assert set(calls[1]) == {"traverse", "traverse.run"} | TILE_STAGES
    assert set(calls[2]) == {"traverse", "traverse.run"} | RAY_STAGES
    for call in calls[1:]:
        run_ids = {s["id"] for s in call["traverse.run"]}
        assert all(s["parent"] == call["traverse"][0]["id"]
                   for s in call["traverse.run"])
        assert all(s["parent"] in run_ids for name, group in call.items()
                   if "." in name and name != "traverse.run"
                   for s in group)
        run = call["traverse.run"][-1]["attrs"]
        assert run["overflow"] == 0 and run["capacity"] > 0
        assert {"run", "pair_capacity", "row_cap", "pair_cap"} <= set(run)
    for s in spans:        # on the CPU the device interval is the host's
        assert s["device_ms"] == s["host_ms"] >= 0 and not s["captured"]


def test_a_span_encloses_a_record_function_range_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.is_on()        # a profiler session turns spans on
        with tracing.span("outer", "cpu"):
            with record_function("inner"):
                torch.ones(64).cumsum(0)
    assert not tracing.is_on()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    outer = by_name(tracing.snapshot()["spans"])["outer"]
    assert len(inner) == 1 and len(outer) == 1
    e, s = inner[0], outer[0]
    assert s["start_ns"] <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s["end_ns"]


def test_program_spans_add_no_profiler_event():
    bvh = tb.build(particles(2000, 12.0))
    alg = tb.TileTraversal(tile=32)
    tb.traverse(bvh, alg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tb.traverse(bvh, alg)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    spans = {s["name"] for s in tracing.snapshot()["spans"]}
    assert {"traverse", "traverse.run"} | TILE_STAGES <= spans
    assert not names & spans


def test_growth_counts_a_capacity_overflow():
    """A scene past its starting capacity: one regrown run, then the same
    call with ``cache`` runs once, warm."""
    bvh = tb.build(particles(3000, 14.0))
    alg = tb.TileTraversal(tile=32, row_cap=32, pair_cap=128)
    with tracing.enabled():
        res = tb.traverse(bvh, alg)
    runs = by_name(tracing.snapshot()["spans"])["traverse.run"]
    bits = [s["attrs"]["overflow"] for s in runs]
    assert res.num_contacts > bvh.num_leaves
    assert bits[-1] == 0 and all(b & 1 for b in bits[:-1]) and len(bits) > 1
    c = tracing.counters()
    assert c["grow.runs"] == len(bits) and c["grow.cold"] == 1
    assert c["grow.capacity"] == sum(b & 1 for b in bits)
    assert c.get("grow.slots", 0) == sum(b >> 1 & 1 for b in bits)
    assert "grow.walks" not in c
    again = tb.traverse(bvh, alg, cache=res)
    assert again.num_contacts == res.num_contacts
    c2 = tracing.counters()
    assert c2["grow.runs"] == c["grow.runs"] + 1
    assert c2["grow.cold"] == 1


def test_growth_past_the_slot_caps_ends_in_one_walk():
    """Two hundred spheres about one point: a tile pair holds far more
    than ``MAX_PAIR_CAP`` contacts, so eight runs, then the walk."""
    bvh = tb.build(particles(200, 0.1, r=1.0))
    with tracing.enabled():
        res = tb.traverse(bvh, tb.TileTraversal())
    assert res.num_contacts == 200 * 199 // 2
    c = tracing.counters()
    assert c["grow.runs"] == 8 and c["grow.walks"] == 1
    assert c["grow.cold"] == 1 and c["calls.traverse"] == 1
    assert c["syncs.tiles.overflow"] == 8 and "syncs.tiles.total" not in c
    named = by_name(tracing.snapshot()["spans"])
    assert len(named["traverse.walk"]) == 1 and len(named["traverse"]) == 1
    walk = named["traverse.walk"][0]
    assert {s["parent"] for s in named["walk.count"] +
            named["walk.write"] + named["walk.scan"]} == {walk["id"]}


@pytest.mark.parametrize("query", ["tiles", "lvt", "rays_lvt"])
def test_syncs_are_the_sites_a_call_hits(query):
    bvh = tb.build(particles(1500, 11.0))
    if query == "tiles":
        res = tb.traverse(bvh, tb.TileTraversal(tile=32))
        tracing.reset()
        tb.traverse(bvh, tb.TileTraversal(tile=32), cache=res)
        want = {"syncs.tiles.overflow": 1, "syncs.tiles.total": 1,
                "syncs.tiles.checks": 1}
    else:
        if query == "lvt":
            tb.traverse(bvh, tb.LVTTraversal())
            total = "syncs.api.total"
        else:
            tb.traverse_rays(bvh, *rays(200, 11.0), tb.LVTTraversal())
            total = "syncs.rays.total"
        # the count and write passes' end tests, one a block of steps
        ends = tracing.counter("walk.steps") // twalk.BLOCK_STEPS
        want = {total: 1, "syncs.walk.end": ends}
        assert ends >= 2
    c = tracing.counters()
    assert {k: v for k, v in c.items() if k.startswith("syncs.")} == want
    assert c["syncs"] == sum(want.values())


def supertiles(n: int, tile: int = 32) -> int:
    """Supertiles of 32 tiles over ``n`` leaves."""
    return -(-(-(-n // tile)) // 32)


@pytest.mark.parametrize("route", ["two_phase", "fallback"])
def test_the_pair_route_marks_its_stages_and_counts_its_grid(route):
    """A fixed two-tree call: ``tiles.fields`` for two bodies, every other
    stage marked ``pair=True``, one ``calls.tiles_pair``, the S1 x S2
    grid's cells, and no host sync."""
    bvh1 = tb.build(particles(3000, 14.0))
    bvh2 = tb.build(particles(2000, 12.0, seed=5))
    capacity = 1 << 15 if route == "two_phase" else 30_000
    with tracing.enabled():
        total, _, overflow, _ = tb.traverse_tiles_pair_fixed(
            bvh1, bvh2, capacity,
            alg=tb.TileTraversal(tile=32, row_cap=16, pair_cap=128))
    assert int(total) > 0 and int(overflow) == 0
    named = by_name(tracing.snapshot()["spans"])
    assert set(named) == (TILE_STAGES if route == "two_phase"
                          else FALLBACK_STAGES)
    assert [s["attrs"] for s in named["tiles.fields"]] == [{"bodies": 2}]
    for name, group in named.items():
        if name != "tiles.fields":
            assert all(s["attrs"] == {"pair": True} for s in group), name
    c = tracing.counters()
    assert c["calls.tiles_pair"] == 1 and c["syncs"] == 0
    assert c["tiles.grid_cells"] == supertiles(3000) * supertiles(2000) == 6


def test_the_self_route_marks_no_stage_and_counts_its_triangle():
    """A fixed self-contact call: ``tiles.fields`` for one body, no stage
    marked ``pair``, no ``calls.tiles_pair``, the triangle's cells."""
    bvh = tb.build(particles(5000, 17.0))
    with tracing.enabled():
        total, _, overflow, _ = tb.traverse_tiles_fixed(
            bvh, 1 << 15, alg=tb.TileTraversal(tile=32, row_cap=16,
                                               pair_cap=128))
    assert int(total) > 0 and int(overflow) == 0
    named = by_name(tracing.snapshot()["spans"])
    assert set(named) == TILE_STAGES
    assert [s["attrs"] for s in named["tiles.fields"]] == [{"bodies": 1}]
    assert all(s["attrs"] == {} for name, group in named.items()
               if name != "tiles.fields" for s in group)
    c = tracing.counters()
    assert "calls.tiles_pair" not in c and c["syncs"] == 0
    assert c["tiles.grid_cells"] == 5 * 6 // 2 == \
        supertiles(5000) * (supertiles(5000) + 1) // 2


@pytest.mark.parametrize("pair_cap, capacity, route", [
    (32, 1 << 15, "two_phase"), (256, 1 << 15, "fallback"),
    (32, 30_000, "fallback"), (128, 2048, "two_phase"),
    (129, 2048, "fallback")])
def test_the_three_fixed_queries_take_one_route(pair_cap, capacity, route):
    """Self, two trees and rays take the same route for the same
    ``(pair_cap, capacity)``: the two-phase route's stages (a count
    stage) for ``pair_cap <= 128`` and whole 1024-contact quanta, the
    fallback's (no count, regroup or merge stage) otherwise."""
    bvh1 = tb.build(particles(600, 8.0))
    bvh2 = tb.build(particles(400, 7.0, seed=5))
    p, d = rays(200, 8.0)
    alg = tb.TileTraversal(tile=32, row_cap=16, pair_cap=pair_cap)
    queries = {
        "tiles": lambda: tb.traverse_tiles_fixed(bvh1, capacity, alg=alg),
        "pair": lambda: tb.traverse_tiles_pair_fixed(bvh1, bvh2, capacity,
                                                     alg=alg),
        "rays": lambda: tb.traverse_rays_tiles_fixed(bvh1, p, d, capacity,
                                                     alg=alg)}
    for query, run in queries.items():
        tracing.reset()
        with tracing.enabled():
            run()
        names = set(by_name(tracing.snapshot()["spans"]))
        stage = "rays" if query == "rays" else "tiles"
        two_phase = {f"{stage}.{s}" for s in ("count", "regroup", "merge")}
        assert (two_phase <= names if route == "two_phase"
                else not two_phase & names), (query, names)
        assert {f"{stage}.phase1", f"{stage}.emit",
                f"{stage}.finish"} <= names, (query, names)


def test_a_growing_pair_call_counts_once():
    """``traverse(bvh1, bvh2, TileTraversal())`` past its slot caps: several
    runs, one ``calls.tiles_pair``, the grid counted a run; with
    ``cache`` one run, one more call."""
    bvh1 = tb.build(particles(3000, 14.0))
    bvh2 = tb.build(particles(2000, 12.0, seed=5))
    alg = tb.TileTraversal(tile=32, row_cap=1, pair_cap=1)
    res = tb.traverse(bvh1, bvh2, alg)
    c = tracing.counters()
    assert c["grow.runs"] > 1 and c.get("grow.slots", 0) >= 1
    assert c["calls.tiles_pair"] == 1
    assert c["tiles.grid_cells"] == 6 * c["grow.runs"]
    tb.traverse(bvh1, bvh2, alg, cache=res)
    c2 = tracing.counters()
    assert c2["calls.tiles_pair"] == 2
    assert c2["grow.runs"] == c["grow.runs"] + 1
    assert c2["tiles.grid_cells"] == c["tiles.grid_cells"] + 6


def test_snapshot_bounds_its_buffer_and_reset_clears(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 4)
    monkeypatch.setattr(tracing, "_spans", __import__("collections").deque(
        maxlen=4))
    with tracing.enabled():
        for k in range(6):
            with tracing.span(f"s{k}"):
                pass
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["s2", "s3", "s4", "s5"]
    assert snap["dropped"] == 2
    tracing.count("x.a")
    tracing.count("y.b", 3)
    tracing.reset("x.")
    assert tracing.counters() == {"y.b": 3, "syncs": 0}
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "counters": {"syncs": 0},
                                  "dropped": 0}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_intervals_on_the_card(cuda):
    bvh = tb.build(particles(1 << 15, 40.0, device=cuda))
    p, d = rays(20_000, 40.0, device=cuda)
    tb.traverse(bvh)
    tb.traverse_rays(bvh, p, d)
    torch.cuda.synchronize()
    with tracing.enabled():
        bvh = tb.build(particles(1 << 15, 40.0, seed=3, device=cuda))
        res = tb.traverse(bvh)
        hits = tb.traverse_rays(bvh, p, d)
    assert res.num_contacts > 0 and hits.num_contacts > 0
    spans = tracing.snapshot()["spans"]
    ids = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert {"build", "traverse"} | BUILD_STAGES | TILE_STAGES | \
        RAY_STAGES <= names
    for s in spans:
        assert s["device_ms"] is not None and s["device_ms"] >= 0
        assert not s["captured"]
    for s in spans:       # children's device time fits in their parent's
        kids = [k for k in spans if k["parent"] == s["id"]]
        assert sum(k["device_ms"] for k in kids) <= s["device_ms"] * 1.02 \
            + 0.05
    assert all(ids[s["parent"]]["call"] == s["call"] for s in spans
               if s["parent"] is not None)


def captured_step(cuda, on: bool):
    """A build + fixed tile query captured in a CUDA graph, with tracing
    on or off during the capture; returns ``(graph, stat, move)``."""
    base = particles(1 << 14, 48.0, device=cuda)
    t = torch.zeros((), device=cuda)
    alg = tb.TileTraversal(row_cap=8, pair_cap=64)

    def step():
        xs = tuple(x + 0.05 * torch.sin(t + k) for k, x in
                   enumerate(base.xs))
        bvh = tb.build(tb.BSphere(xs, base.r))
        total, _, overflow, _ = tb.traverse_tiles_fixed(
            bvh, 1 << 17, alg=alg, pair_capacity=1 << 17)
        t.add_(1.0)
        return torch.stack([total, overflow])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    if on:
        with tracing.enabled(), torch.cuda.graph(graph):
            stat = step()
    else:
        with torch.cuda.graph(graph):
            stat = step()
    return graph, stat, step


def replay_ops(graph) -> int:
    """Device operations of one replay, by the profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


@pytest.mark.gpu
def test_a_graph_captured_with_tracing_on_times_every_stage(cuda):
    graph, stat, _ = captured_step(cuda, on=True)
    captured = tracing.snapshot()["spans"]
    names = {s["name"] for s in captured}
    assert {"build"} | BUILD_STAGES | TILE_STAGES <= names
    assert all(s["captured"] for s in captured)
    last = None
    for _ in range(3):
        graph.replay()
        spans = tracing.snapshot()["spans"]
        assert len(spans) == len(captured)
        ms = [s["device_ms"] for s in spans]
        assert all(m is not None and m >= 0 for m in ms)
        assert int(stat[1]) == 0 and int(stat[0]) > 0
        last = ms
    assert sum(last) > 0


@pytest.mark.gpu
def test_a_captured_pair_query_times_its_stages(cuda):
    """A two-tree build + fixed tile query captured with tracing on: every
    stage, ``tiles.fields`` for two bodies and the rest marked ``pair``,
    has a device time after each replay; the capture made no host
    sync."""
    bvh1 = tb.build(particles(1 << 15, 40.0, r=0.2, device=cuda))
    base = particles(1 << 13, 20.0, r=0.2, seed=5, device=cuda)
    t = torch.zeros((), device=cuda)
    alg = tb.TileTraversal(row_cap=16, pair_cap=128)

    def step():
        xs = tuple(x + 10.0 + 0.5 * torch.sin(t) for x in base.xs)
        bvh2 = tb.build(tb.BSphere(xs, base.r))
        total, _, overflow, _ = tb.traverse_tiles_pair_fixed(
            bvh1, bvh2, 1 << 17, alg=alg)
        t.add_(1.0)
        return torch.stack([total, overflow])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    tracing.reset()
    graph = torch.cuda.CUDAGraph()
    with tracing.enabled(), torch.cuda.graph(graph):
        stat = step()
    assert tracing.counters()["syncs"] == 0
    named = by_name(tracing.snapshot()["spans"])
    assert TILE_STAGES <= set(named)
    assert [s["attrs"] for s in named["tiles.fields"]] == [{"bodies": 2}]
    for _ in range(2):
        graph.replay()
        assert int(stat[1]) == 0 and int(stat[0]) > 0
        spans = tracing.snapshot()["spans"]
        for s in spans:
            assert s["captured"] and s["device_ms"] is not None
            if s["name"] in TILE_STAGES - {"tiles.fields"}:
                assert s["attrs"] == {"pair": True}
    assert sum(s["device_ms"] for s in spans
               if s["name"] == "tiles.fields") > 0


@pytest.mark.gpu
def test_a_graph_captured_with_tracing_off_is_the_untraced_graph(cuda):
    """Off, the capture records no span and the graph holds the same
    device work as one captured with tracing on (whose event records are
    no device operation)."""
    off, _, _ = captured_step(cuda, on=False)
    assert tracing.snapshot()["spans"] == []
    on, _, _ = captured_step(cuda, on=True)
    assert replay_ops(off) == replay_ops(on) > 0
