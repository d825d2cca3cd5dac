"""The whole compaction ``compact_flat`` (B5 with ``finish_compact``) and
the emit kernel B3 (``tile_group_emit``, with its plan ``emit_plan``) on
synthetic inputs.

On the CPU: ``compact_flat``'s plain path against ``finish_compact`` of
``tile_compact_plain`` and against a loop over the mask, on masks with no
survivor, every survivor, a row over ``row_cap``, a mega-tile over ``cap``,
a total over ``capacity``, one mega-tile and many; the plan's plain version
against ``_emit_offsets`` with dead steps, entries with ``cnt = 0`` and
``cnt > CAP_PAIR``, and ``nsteps`` of 0 and past ``S_cap``; and that the
emit scenes of the card tests hold their edge cases.  ``gpu``-marked tests
hold ``compact_flat``, the plan and B3 against their plain versions, bit for
bit, and skip without a card.  Every comparison is exact (integers; the
predicates compare identically rounded float32 values).  No JAX here.
"""

import numpy as np
import pytest
import torch

from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch.ops import tile_contact as tc

from test_torch_count_slot import MASKS, S_CAP, field_sets

MEGA = 128 * 128

# case -> (mega-tiles, survivor density, cap, row_cap, capacity)
COMPACT = {
    "empty": (2, 0.0, 256, 8, 1024),
    "full": (1, 1.0, 2048, 128, 4096),
    "row_over_row_cap": (2, 0.02, 512, 2, 4096),
    "tile_over_cap": (3, 0.03, 256, 128, 8192),
    "total_over_capacity": (3, 0.01, 512, 128, 300),
    "one_tile": (1, 0.01, 512, 8, 1000),
    "many_tiles": (9, 0.005, 512, 8, 1 << 14),
}


def compact_case(case):
    tiles, density, cap, row_cap, capacity = COMPACT[case]
    rng = np.random.default_rng(len(case))
    M = tiles * MEGA
    mask = rng.random(M) < density
    if case == "row_over_row_cap":
        mask[MEGA + 5 * 128: MEGA + 5 * 128 + 40] = True
    pay = tuple(torch.from_numpy(rng.integers(0, 1 << 30, M)
                                 .astype(np.int32)) for _ in range(2))
    return (torch.from_numpy(mask), pay,
            dict(cap=cap, row_cap=row_cap, capacity=capacity))


def compact_loop(mask, pay, cap, row_cap, capacity):
    """The flat lists by a loop: each mega-tile's slots in order, the s-th
    survivor of a row at slot row_off + s (zero where past row_cap), the
    first min(count, cap) slots of each tile one after another."""
    m = mask.numpy().reshape(-1, 128, 128)
    p = [x.numpy().reshape(-1, 128, 128) for x in pay]
    flat = [[], []]
    over = False
    for t in range(m.shape[0]):
        slots = [[], []]
        for r in range(128):
            lanes = np.nonzero(m[t, r])[0]
            over |= len(lanes) > row_cap
            for s, lane in enumerate(lanes):
                for q in range(2):
                    slots[q].append(p[q][t, r, lane] if s < row_cap else 0)
        over |= len(slots[0]) > cap
        for q in range(2):
            flat[q] += slots[q][:cap]
    total = len(flat[0])
    lists = [np.zeros(capacity, np.int32) for _ in range(2)]
    for q in range(2):
        n = min(total, capacity)
        lists[q][:n] = flat[q][:n]
    return lists, total, over


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_flat_plain(case):
    mask, pay, kw = compact_case(case)
    lists, total, over = ops.compact_flat(mask, pay, **kw)   # CPU: plain
    slots, counts, c_over = ops.tile_compact_plain(
        mask, pay, cap=kw["cap"], row_cap=kw["row_cap"])
    want, want_total = ops.finish_compact(slots, counts, kw["capacity"])
    assert total.dtype == torch.int32 and total.dim() == 0
    assert over.dtype == torch.bool and over.dim() == 0
    assert int(total) == int(want_total) and bool(over) == bool(c_over)
    for g, w in zip(lists, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    loop, loop_total, loop_over = compact_loop(mask, pay, **kw)
    assert int(total) == loop_total and bool(over) == loop_over
    for g, w in zip(lists, loop):
        assert np.array_equal(g.numpy(), w)
    expect_over = case in ("row_over_row_cap", "tile_over_cap", "full")
    assert loop_over == expect_over
    if case == "total_over_capacity":
        assert loop_total > kw["capacity"]


def test_compact_flat_checks():
    mask, pay, kw = compact_case("one_tile")
    with pytest.raises(ValueError):
        ops.compact_flat(mask, pay, **dict(kw, capacity=0))
    with pytest.raises(ValueError):
        ops.compact_flat(mask, pay[:1], **kw)
    with pytest.raises(ValueError):
        ops.compact_flat(mask[:1000], tuple(p[:1000] for p in pay), **kw)


# ---------------------------------------------------------------------------
# The emit kernel's plan and scenes
# ---------------------------------------------------------------------------

def plan_inputs(seed, S_cap=8, W=4):
    """An emit list: dead steps, pad entries (cnt 0), cnt past CAP_PAIR
    and up to 255, okc bits, and nsteps of 0, midway, S_cap and past it."""
    rng = np.random.default_rng(seed)
    SW = S_cap * W
    cnt = rng.integers(0, 256, SW)
    cnt[rng.random(SW) < 0.3] = 0
    small = rng.random(SW) < 0.3
    cnt[small] = rng.integers(1, 4, int(small.sum()))
    b_idx = (rng.integers(0, 50, SW) | (rng.integers(0, 16, SW) << 16)
             | (cnt << 20) | (rng.integers(0, 2, SW) << 28)).astype(np.int32)
    return torch.from_numpy(b_idx), [
        torch.tensor([n], dtype=torch.int32)
        for n in (0, S_cap // 2, S_cap, S_cap + 5)]


@pytest.mark.parametrize("CAP_PAIR", [1, 32, 128])
def test_emit_plan_plain_matches_offsets(CAP_PAIR):
    """The live entries are the entries with cnt > 0 of the live steps, in
    order, with the offsets and total of ``_emit_offsets``."""
    S_cap, W = 8, 4
    b_idx, nsteps_list = plan_inputs(CAP_PAIR, S_cap, W)
    for nsteps in nsteps_list:
        entries, offsets, total, nlive = ops.emit_plan(
            b_idx, nsteps, S_cap=S_cap, CAP_PAIR=CAP_PAIR)
        offs, want_total = tc._emit_offsets(b_idx, nsteps, S_cap, W,
                                            CAP_PAIR)
        live = [e for e in range(S_cap * W)
                if (int(b_idx[e]) >> 20) & 0xFF and
                e // W < min(int(nsteps), S_cap)]
        n = int(nlive)
        assert n == len(live) and entries[:n].tolist() == live
        assert torch.equal(offsets[:n], offs[live])
        assert int(total) == int(want_total)
        assert total.dtype == nlive.dtype == torch.int32
        if int(nsteps) == 0:
            assert n == 0 and int(total) == 0
    with pytest.raises(ValueError):
        ops.emit_plan(b_idx, nsteps_list[0], S_cap=5, CAP_PAIR=32)


W_E = 4          # entries per step of the emit scenes


def emit_inputs(kind, G, seed, dedup, a, b):
    """The emit list of a scene: each entry's cnt and okc from its true
    contact count and largest column count (clamped at 255, as the
    regrouping does), so rows over ROW_CAP and columns over 2 occur; plus
    pad entries (cnt 0, tj = Tb), an entry whose cnt exceeds its contacts
    (its range keeps zeros) and one whose okc is set over a column of 3 or
    more contacts.  Returns ``(a_idx, b_idx)``."""
    rng = np.random.default_rng(seed)
    Ta, Tb = a.shape[1], b.shape[1]
    SW = S_CAP * W_E
    a_idx = torch.from_numpy(rng.integers(0, Ta, S_CAP).astype(np.int32))
    tj = torch.from_numpy(rng.integers(0, Tb, SW))
    if dedup:
        tj[::3] = a_idx[torch.arange(0, SW, 3) // W_E].long()
    band = torch.from_numpy(rng.integers(1, 16, SW))
    ti = a_idx[torch.arange(SW) // W_E].long()
    m = tc._pair_masks(a, b, ti, tj, band, 4, kind, dedup)
    cnt = m.sum((1, 2)).clamp(max=255)
    okc = (m.sum(1).amax(1) <= 2).long()
    pad = torch.from_numpy(rng.random(SW) < 0.15)
    cnt[pad] = 0
    tj[pad] = Tb
    busy = (cnt > 0).nonzero().squeeze(1)
    if busy.numel() >= 2:
        cnt[busy[0]] = (cnt[busy[0]] + 3).clamp(max=255)
        okc[busy[1]] = 1
    b_idx = (tj | (band << 16) | (cnt << 20) | (okc << 28)).int()
    return a_idx, b_idx


def _cluster(f):
    """Make the first 12 leaves of every tile one sphere (or its box), so
    that leaf-leaf scenes have rows over ROW_CAP and columns over 2 at every
    tile size (the ray scenes have them from their lattice)."""
    if f.shape[0] == 4:
        f[:3, :, :12], f[3, :, :12] = 2.0, 0.5
    else:
        f[:3, :, :12], f[3:, :, :12] = 1.5, 2.5


def emit_scenes(G, dev=None, dtype=torch.float32):
    """(kind, dedup, a, b, a_idx, b_idx) of every mask, one and two field
    sets, the fields in ``dtype`` (the lattice values are exact in both)."""
    cases = [(k, False) for k in MASKS] + [("sphere", True), ("box", True)]
    for n, (kind, dedup) in enumerate(cases):
        a, b = field_sets(kind, G, 7 * G + n, dedup)
        if not kind.startswith("ray"):
            for f in {id(a): a, id(b): b}.values():
                _cluster(f)
        a_idx, b_idx = emit_inputs(kind, G, G + n, dedup, a, b)
        a = a.to(dtype)
        b = a if dedup else b.to(dtype)
        if dev is not None:
            a, b, a_idx, b_idx = (t.to(dev) for t in (a, b, a_idx, b_idx))
        yield kind, dedup, a, (None if dedup else b), a_idx, b_idx


def emit_calls(kind, dedup, a, b, a_idx, b_idx):
    """Argument sets of one scene: nsteps 0, midway and past S_cap; the
    slot caps of the two-phase route and the ray route; a CAP that holds
    the stream and one that cuts it."""
    dev = a.device
    for n in (0, S_CAP // 2, S_CAP + 3):
        nsteps = torch.tensor([n], dtype=torch.int32, device=dev)
        for row_cap, cap_pair in ((4, 32), (8, 128)):
            kw = dict(mask_kind=kind, ROW_CAP=row_cap, CAP_PAIR=cap_pair,
                      dedup=dedup)
            total = int(tc._emit_offsets(b_idx, nsteps, S_CAP, W_E,
                                         cap_pair)[1])
            for CAP in (total + 37, max(1, total // 2)):
                yield (a_idx, b_idx, nsteps, a, b), dict(kw, CAP=CAP)


def test_emit_scenes_hold_their_edge_cases():
    """The card tests' scenes give slow pairs with a row over ROW_CAP (flag
    bit 1), streams over CAP (bit 0), okc and slow entries, pad entries,
    entries whose range keeps zeros, and nsteps 0."""
    seen = set()
    for kind, dedup, a, b, a_idx, b_idx in emit_scenes(32):
        okc = (b_idx >> 28) & 1
        cnt = (b_idx >> 20) & 0xFF
        seen |= {"okc"} if bool(((okc == 1) & (cnt > 0)).any()) else set()
        seen |= {"slow"} if bool(((okc == 0) & (cnt >= 2)).any()) else set()
        seen |= {"pad"} if bool((cnt == 0).any()) else set()
        for args, kw in emit_calls(kind, dedup, a, b, a_idx, b_idx):
            gi, gj, total, flags = ops.tile_group_emit(*args, **kw)
            f = int(flags)
            if f & 2:
                seen.add(("row over ROW_CAP", kind))
            if f & 1:
                seen.add("over CAP")
            if int(args[2]) == 0:
                assert int(total) == 0 and not gi.any() and f == 0
            n = min(int(total), kw["CAP"])
            if bool(((gi[:n] == 0) & (gj[:n] == 0)).any()):
                seen.add("zeros in a range")
    for want in ("okc", "slow", "pad", "over CAP", "zeros in a range"):
        assert want in seen, want
    for kind in MASKS:
        assert ("row over ROW_CAP", kind) in seen, kind


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_flat_matches_plain_on_card(cuda, case):
    mask, pay, kw = compact_case(case)
    mask, pay = mask.to(cuda), tuple(p.to(cuda) for p in pay)
    lists, total, over = ops.compact_flat(mask, pay, **kw)
    want, want_total, want_over = ops.compact_flat_plain(mask, pay, **kw)
    torch.cuda.synchronize()
    assert total.dtype == torch.int32 and over.dtype == torch.bool
    assert int(total) == int(want_total) and bool(over) == bool(want_over)
    for g, w in zip(lists, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_emit_plan_matches_plain_on_card(cuda):
    S_cap, W = 8, 4
    b_idx, nsteps_list = plan_inputs(5, S_cap, W)
    b_idx = b_idx.to(cuda)
    for nsteps in nsteps_list:
        nsteps = nsteps.to(cuda)
        for CAP_PAIR in (1, 32, 128):
            got = ops.emit_plan(b_idx, nsteps, S_cap=S_cap, CAP_PAIR=CAP_PAIR)
            want = ops.emit_plan_plain(b_idx, nsteps, S_cap=S_cap,
                                       CAP_PAIR=CAP_PAIR)
            n = int(want[3])
            assert int(got[3]) == n and int(got[2]) == int(want[2])
            assert torch.equal(got[0][:n], want[0][:n])
            assert torch.equal(got[1][:n], want[1][:n])
    # many chunks of the one-block scan
    rng = np.random.default_rng(9)
    S_cap, W = 40_000, 8
    b_idx = torch.from_numpy((rng.integers(0, 3, S_cap * W) << 20)
                             .astype(np.int32)).to(cuda)
    nsteps = torch.tensor([S_cap - 7], dtype=torch.int32, device=cuda)
    got = ops.emit_plan(b_idx, nsteps, S_cap=S_cap, CAP_PAIR=32)
    want = ops.emit_plan_plain(b_idx, nsteps, S_cap=S_cap, CAP_PAIR=32)
    n = int(want[3])
    assert int(got[3]) == n > 0 and int(got[2]) == int(want[2])
    assert torch.equal(got[0][:n], want[0][:n])
    assert torch.equal(got[1][:n], want[1][:n])


@pytest.mark.gpu
@pytest.mark.parametrize("G", [32, 64, 128, 256, 800, 1024])
def test_group_emit_matches_plain_on_card(cuda, G):
    """B3 equals its plain version bit for bit (both streams in full, the
    total and the flags): every mask, one and two field sets, okc and slow
    entries, rows over ROW_CAP, streams over CAP, every nsteps case, NaN
    rows and contacts on the boundary."""
    _check_group_emit(cuda, G, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [32, 64, 128, 256, 800, 1024])
def test_group_emit_matches_plain_on_card_float64(cuda, G):
    """B3's double kernel equals its plain version, as in float32."""
    _check_group_emit(cuda, G, torch.float64)


def _check_group_emit(cuda, G, dtype):
    for scene in emit_scenes(G, cuda, dtype):
        for args, kw in emit_calls(*scene):
            got = ops.tile_group_emit(*args, **kw)
            want = ops.tile_group_emit_plain(*args, **kw)
            torch.cuda.synchronize()
            label = (kw["mask_kind"], kw["dedup"], int(args[2]), kw["CAP"],
                     kw["CAP_PAIR"])
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape, label
                assert torch.equal(g, w), label
