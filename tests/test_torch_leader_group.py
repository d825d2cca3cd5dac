"""The leader packing L1 (``ops.leader_group``) and its plain version.

On the CPU: ``leader_group_plain`` against a loop over the entries, on
small cases (segments longer than W, invalid entries inside a segment, an
invalid entry of another ti that splits a segment, every entry invalid,
steps past ``S_cap`` with ``nsteps`` uncapped, a first ti of -1, the
plain version's sentinel), with int32 and int64 ti and 1 to 3 payloads
(int64 values past 32 bits, a strided int32 column); a numpy model of the
kernel's scan (per-thread carries, block tiles, the carries of the tiles
before) against the same loop; the wrapper on CPU tensors (the plain
version, no launch) and its refusals.  ``gpu``-marked tests hold the
kernel against the plain version bit for bit at the main path's five
shapes and at ragged sizes across its tile boundaries, for 1, 2, 3 and 17
payloads, once inside a CUDA graph, and count its launches in the tile
engine's fixed calls; they skip without a card.  No JAX here.
"""

import numpy as np
import pytest
import torch

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops


def _wrap32(x):
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def loop_group(ti, valid, payloads, pads, W, S_cap):
    """The definition, one entry at a time: (a_idx, grouped, nsteps)."""
    ti = [int(t) for t in ti]
    a_idx = [0] * S_cap
    grouped = [[int(p)] * (S_cap * W) for p in pads]
    n_seg = 1           # entry 0 starts a segment unless its ti is -1
    leaders = 0
    for i, t in enumerate(ti):
        if t != (ti[i - 1] if i else -1):
            n_seg = 0
        if not valid[i]:
            continue
        posr = n_seg
        n_seg += 1
        if posr % W == 0:
            leaders += 1
            if leaders - 1 < S_cap:
                a_idx[leaders - 1] = _wrap32(t)
        gid = leaders - 1
        if 0 <= gid < S_cap:
            for q, p in enumerate(payloads):
                grouped[q][gid * W + posr % W] = _wrap32(p[i])
    return a_idx, grouped, leaders


def _sorted_ti(rng, E, max_seg):
    lens = rng.integers(1, max_seg + 1, E)
    return np.repeat(np.cumsum(rng.integers(1, 4, E)), lens)[:E]


def _case(name, rng):
    """(ti, valid, W, S_cap) of a named case."""
    if name == "segments_past_w":
        ti = _sorted_ti(rng, 160, 13)
        return ti, np.ones(160, bool), 3, 256
    if name == "invalid_inside":
        ti = _sorted_ti(rng, 200, 11)
        return ti, rng.random(200) < 0.7, 4, 256
    if name == "invalid_splits":
        ti = np.array([2, 2, 2, 7, 2, 2, 2, 2, 2, 5, 5, 9, 5, 5])
        valid = np.ones(14, bool)
        valid[[3, 11]] = False
        return ti, valid, 2, 64
    if name == "all_invalid":
        return _sorted_ti(rng, 50, 6), np.zeros(50, bool), 4, 16
    if name == "past_s_cap":
        ti = _sorted_ti(rng, 120, 9)
        return ti, rng.random(120) < 0.8, 2, 5
    if name == "sentinel_first":
        ti = np.concatenate([np.full(9, -1), _sorted_ti(rng, 40, 5)])
        return ti, rng.random(49) < 0.8, 4, 64
    if name == "random_w8":
        ti = _sorted_ti(rng, 300, 20)
        valid = rng.random(300) < 0.9
        valid[250:] = False                 # a dead tail, as run lists have
        return ti, valid, 8, 64
    raise KeyError(name)


CASES = ("segments_past_w", "invalid_inside", "invalid_splits",
         "all_invalid", "past_s_cap", "sentinel_first", "random_w8")


def _payloads(rng, E, k):
    """k payloads: int64 past 32 bits, a strided int32 column, int32."""
    out = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, E))]
    mat = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (E, 3),
                                        dtype=np.int64).astype(np.int32))
    out.append(mat[:, 1])
    out.append(torch.from_numpy(rng.integers(0, 1 << 16, E).astype(np.int32)))
    return out[:k], (-7, 0, 65535)[:k]


def _inputs(name, ti_dtype, k, seed=0):
    rng = np.random.default_rng(seed)
    ti, valid, W, S_cap = _case(name, rng)
    payloads, pads = _payloads(rng, len(ti), k)
    return (torch.from_numpy(np.asarray(ti)).to(ti_dtype),
            torch.from_numpy(np.asarray(valid)), payloads, pads, W, S_cap)


def _as_lists(out):
    a_idx, grouped, nsteps = out
    assert a_idx.dtype == torch.int32 and nsteps.dtype == torch.int32
    assert nsteps.dim() == 0
    assert all(g.dtype == torch.int32 for g in grouped)
    return a_idx.tolist(), [g.tolist() for g in grouped], int(nsteps)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("ti_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_loop(name, ti_dtype, k):
    ti, valid, payloads, pads, W, S_cap = _inputs(name, ti_dtype, k)
    got = _as_lists(ops.leader_group_plain(ti, valid, payloads, pads, W,
                                           S_cap))
    want = loop_group(ti.tolist(), valid.tolist(),
                      [p.tolist() for p in payloads], pads, W, S_cap)
    assert got == want
    if name == "past_s_cap":
        assert got[2] > S_cap
    if name == "all_invalid":
        assert got[2] == 0


# ---------------------------------------------------------------------------
# A model of the kernel's scan (csrc/leader_group.cu), in Python
# ---------------------------------------------------------------------------

def _combine(a, b, W):
    if not b[0]:
        return (a[0], a[1] if a[0] else a[1] + b[1], a[2], a[3] + b[1])
    if not a[0]:
        return (1, a[1] + b[1], b[2], b[3])
    return (1, a[1], a[2] + -(-(a[3] + b[1]) // W) + b[2], b[3])


def _fold(carries, W, start=(0, 0, 0, 0)):
    for c in carries:
        start = _combine(start, c, W)
    return start


def model_group(ti, valid, W, S_cap, items, threads):
    """The kernel's arithmetic: entries as carries, summed per thread of
    ``items`` entries and per tile of ``threads`` threads; each entry's
    prefix from the phantom, the tiles before, the threads before and the
    thread's entries before.  Returns (slot of each entry or -1, leaders'
    (gid, index), nsteps)."""
    E = len(ti)
    starts = [int(ti[i] != (ti[i - 1] if i else -1)) for i in range(E)]
    ent = [(c, 0 if c else int(v), 0, int(v)) for c, v in zip(starts, valid)]
    tile = items * threads
    thread_sums = [_fold(ent[f:f + items], W) for f in range(0, E, items)]
    tile_sums = [_fold(thread_sums[t:t + threads], W)
                 for t in range(0, len(thread_sums), threads)]
    slots, leads = [-1] * E, []
    for i in range(E):
        b, t = divmod(i, tile)
        pre = _fold(tile_sums[:b], W, (1, 0, -1, 1))
        pre = _fold(thread_sums[b * threads:b * threads + t // items], W, pre)
        pre = _fold(ent[i - i % items:i], W, pre)
        if not valid[i]:
            continue
        c = starts[i]
        posr = 0 if c else pre[3]
        gid = pre[2] + (-(-pre[3] // W) if c else 0) + posr // W
        if 0 <= gid < S_cap:
            slots[i] = gid * W + posr % W
            if posr % W == 0:
                leads.append((gid, i))
    total = _fold(tile_sums, W, (1, 0, -1, 1))
    return slots, leads, total[2] + -(-total[3] // W)


@pytest.mark.parametrize("items,threads", [(1, 1), (4, 3), (3, 8)])
@pytest.mark.parametrize("name", CASES)
def test_kernel_scan_model_matches_loop(name, items, threads):
    """The carry algebra, tiled three ways, places every entry as the loop
    does (small tiles, so that segments cross threads and tiles)."""
    ti, valid, payloads, pads, W, S_cap = _inputs(name, torch.int64, 1)
    ti, valid = ti.tolist(), valid.tolist()
    slots, leads, nsteps = model_group(ti, valid, W, S_cap, items, threads)
    idx = list(range(len(ti)))
    a_idx, (grouped,), want_steps = loop_group(ti, valid, [idx], [-1], W,
                                               S_cap)
    assert nsteps == want_steps
    got = [-1] * (S_cap * W)
    for i, s in enumerate(slots):
        if s >= 0:
            got[s] = i
    assert got == grouped
    got_a = [0] * S_cap
    for gid, i in leads:
        got_a[gid] = _wrap32(ti[i])
    assert got_a == a_idx


def test_wrapper_on_cpu_is_plain_without_launch():
    ti, valid, payloads, pads, W, S_cap = _inputs("random_w8", torch.int64,
                                                  3)
    ops.reset_launch_counts()
    got = ops.leader_group(ti, valid, payloads, pads, W, S_cap)
    want = ops.leader_group_plain(ti, valid, payloads, pads, W, S_cap)
    assert _as_lists(got) == _as_lists(want)
    assert ops.launch_count(ops.leader_group) == 0


@pytest.mark.parametrize("bad", ["float_ti", "ti_2d", "empty", "valid_int",
                                 "valid_short", "payload_short", "payload_float",
                                 "no_payload",
                                 "pads_short", "too_many", "pad_range",
                                 "w_zero", "s_cap_zero"])
def test_wrapper_refusals(bad):
    ti, valid, payloads, pads, W, S_cap = _inputs("random_w8", torch.int64,
                                                  2)
    args = dict(ti_flat=ti, valid=valid, payloads=payloads, pads=pads, W=W,
                S_cap=S_cap)
    E = ti.shape[0]
    change = {
        "float_ti": dict(ti_flat=ti.float()),
        "ti_2d": dict(ti_flat=ti.view(1, E)),
        "empty": dict(ti_flat=ti[:0], valid=valid[:0],
                      payloads=[p[:0] for p in payloads]),
        "valid_int": dict(valid=valid.int()),
        "valid_short": dict(valid=valid[1:]),
        "payload_short": dict(payloads=[payloads[0], payloads[1][1:]]),
        "payload_float": dict(payloads=[payloads[0], payloads[1].float()]),
        "no_payload": dict(payloads=[], pads=[]),
        "pads_short": dict(pads=pads[:1]),
        "too_many": dict(payloads=[payloads[0]] * 33, pads=[0] * 33),
        "pad_range": dict(pads=(0, 1 << 31)),
        "w_zero": dict(W=0),
        "s_cap_zero": dict(S_cap=0),
    }[bad]
    args.update(change)
    with pytest.raises((TypeError, ValueError)):
        ops.leader_group(**args)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_inputs(E, k, W, S_cap, ti_dtype, seed, live=0.8, run=1,
                max_seg=40):
    """A list like the main path's: ti sorted in segments (each value
    repeated ``run`` times in a row, as the regroup repeats a run's ti R
    times), a dead tail past ``live`` of the entries (ti 65,535, as the
    sentinel key gives) and dead entries inside; payloads as
    :func:`_payloads` gives, cycled past the third."""
    rng = np.random.default_rng(seed)
    n = -(-E // run)
    ti = np.repeat(_sorted_ti(rng, n, max_seg), run)[:E]
    valid = rng.random(E) < 0.9
    n_live = int(E * live)
    valid[n_live:] = False
    ti[n_live:] = 65535
    p3, pads3 = _payloads(rng, E, 3)
    payloads = [p3[q] if q < 3 else p3[q % 3] + q for q in range(k)]
    pads = [pads3[q] if q < 3 else q for q in range(k)]
    return (torch.from_numpy(ti).to(ti_dtype), torch.from_numpy(valid),
            payloads, pads, W, S_cap)


def _on(dev, inputs):
    ti, valid, payloads, pads, W, S_cap = inputs
    return (ti.to(dev), valid.to(dev), [p.to(dev) for p in payloads], pads,
            W, S_cap)


def _card_equals_plain(args):
    before = ops.launch_count(ops.leader_group)
    a, g, n = ops.leader_group(*args)
    torch.cuda.synchronize()
    assert ops.launch_count(ops.leader_group) == before + 1
    wa, wg, wn = ops.leader_group_plain(*args)
    return (torch.equal(a, wa) and len(g) == len(wg)
            and all(torch.equal(x, y) for x, y in zip(g, wg))
            and torch.equal(n, wn))


# the main path's lists: run lists (98,304 and 65,536 entries, two
# payloads, int64 ti, W 8) and emit lists (int32 ti repeated R = 8 times,
# one payload, W 4 or 8)
MAIN_SHAPES = {
    "particles_runs": (98304, 2, 8, 49152, torch.int64, 1),
    "two_body_runs": (65536, 2, 8, 32768, torch.int64, 1),
    "particles_regroup": (131072, 1, 4, 49152, torch.int32, 8),
    "two_body_regroup": (144384, 1, 4, 49152, torch.int32, 8),
    "rays_regroup": (1048576, 1, 8, 147456, torch.int32, 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_kernel_matches_plain_at_main_shapes(cuda, shape):
    E, k, W, S_cap, ti_dtype, run = MAIN_SHAPES[shape]
    args = _on(cuda, card_inputs(E, k, W, S_cap, ti_dtype, seed=E, run=run))
    assert _card_equals_plain(args), shape


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 17])
@pytest.mark.parametrize("E", [1, 2, 1023, 1025, 4097, 262144, 262145,
                               300001])
def test_kernel_matches_plain_at_ragged_sizes(cuda, E, k):
    """Sizes around the tile (1,024 entries) and around 256 tiles, where a
    thread of the scan pass starts to combine more than one carry of the
    tiles before; W 1, 3 and 8; S_cap past and short of the steps."""
    for W, ti_dtype in ((1, torch.int32), (3, torch.int64), (8, torch.int32)):
        S_cap = max(1, E // (2 * W))
        args = _on(cuda, card_inputs(E, k, W, S_cap, ti_dtype,
                                     seed=E * k + W, max_seg=7))
        assert _card_equals_plain(args), (E, k, W)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_cases(cuda, name):
    for ti_dtype in (torch.int32, torch.int64):
        assert _card_equals_plain(_on(cuda, _inputs(name, ti_dtype, 3))), name


@pytest.mark.gpu
def test_kernel_captured_in_a_graph(cuda):
    """Captured once, replayed on new inputs copied into the captured ones:
    the plain version's outputs."""
    E, k, W, S_cap, ti_dtype, run = MAIN_SHAPES["particles_runs"]
    static = _on(cuda, card_inputs(E, k, W, S_cap, ti_dtype, seed=1))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        ops.leader_group(*static)           # warm-up: builds and loads
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ops.leader_group(*static)
    fresh = _on(cuda, card_inputs(E, k, W, S_cap, ti_dtype, seed=2))
    static[0].copy_(fresh[0])
    static[1].copy_(fresh[1])
    for p, q in zip(static[2], fresh[2]):
        p.copy_(q)
    g.replay()
    torch.cuda.synchronize()
    wa, wg, wn = ops.leader_group_plain(*fresh)
    assert torch.equal(out[0], wa) and torch.equal(out[2], wn)
    assert all(torch.equal(x, y) for x, y in zip(out[1], wg))


@pytest.mark.gpu
def test_launches_in_the_fixed_calls(cuda):
    """Two launches a self or two-tree two-phase call (the run lists and
    the emit lists), one a ray tile run (the emit lists; ray phase 1 packs
    its own)."""
    rng = np.random.default_rng(3)

    def spheres(n, seed):
        r = np.random.default_rng(seed)
        return tb.build(tb.BSphere(r.random((n, 3)).astype(np.float32) * 12,
                                   np.full(n, 0.2, np.float32),
                                   device="cuda"))

    bvh, bvh2 = spheres(3000, 1), spheres(2000, 2)
    ops.reset_launch_counts()
    total = tb.traverse_tiles_fixed(bvh, 8192)[0]
    assert int(total) > 0
    assert ops.launch_count(ops.leader_group) == 2
    ops.reset_launch_counts()
    total = tb.traverse_tiles_pair_fixed(bvh, bvh2, 8192)[0]
    assert int(total) > 0
    assert ops.launch_count(ops.leader_group) == 2
    p = (rng.random((3, 500)) * 12).astype(np.float32)
    d = rng.standard_normal((3, 500)).astype(np.float32)
    ops.reset_launch_counts()
    total = tb.traverse_rays_tiles_fixed(bvh, p, d, 8192)[0]
    assert int(total) > 0
    assert ops.launch_count(ops.leader_group) == 1
