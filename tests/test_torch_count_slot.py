"""The count kernel B2 (``tile_run_counts``) and the slot kernels B4/B6
(``tile_group_contacts``, ``tile_pair_contacts``) on synthetic inputs.

The inputs are made with numpy from a seed: leaves on a half-integer
lattice (so that spheres touch and boxes share faces exactly: contacts on
the boundary), rays from lattice points with zero direction components (so
that some lie in a box face plane), NaN padding at the end of the last tile
of each set, b-tiles past ``Tb``, diagonal pairs under ``dedup``, and
``nsteps`` at 0, midway and above ``S_cap``.

On the CPU: :func:`run_live_pairs` against a loop over the pairs and
against the plain version's zero rows, the scenes' edge cases, and that the
moment decode reads no word row outside the live pairs (the card leaves
those rows unwritten).  ``gpu``-marked tests hold each kernel against its
plain version at tiles of 32 to 256 (one warp and several per block), all
four masks, NB 4/8/16 and R 8/32, and at tiles 800 and 1024, where the
slot kernels need more than 48 KB of shared memory; in float32 and again
in float64 (the same lattice values, exact in both; double records pass
48 KB from tile 128); they skip without a card.  No JAX here: the file runs as it is on a machine that has only the
port.
"""

import numpy as np
import pytest
import torch

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch.traverse import ray_tiles as tray
from implicitbvh_tpu_torch.traverse import tiles as ttiles

MASKS = ("sphere", "box", "ray_box", "ray_sphere")
TA, TB = 5, 6        # tiles of the a and b sets
S_CAP, W = 6, 2


def leaves(rng, kind, T, G):
    """(F, T, G) float32 spheres or boxes: half of them centred on integer
    lattice points with radius 0.5 (neighbours touch exactly), half at
    random in the same cube; the last 5 entries are NaN."""
    n = T * G
    c = np.floor(rng.random((n, 3)) * 5).astype(np.float32)
    r = np.full(n, 0.5, np.float32)
    rand = rng.random(n) < 0.5
    c[rand] = (rng.random((int(rand.sum()), 3)) * 5).astype(np.float32)
    r[rand] = (rng.random(int(rand.sum())) * 0.6 + 0.05).astype(np.float32)
    if kind == "sphere":
        f = np.concatenate([c, r[:, None]], 1)
    else:
        f = np.concatenate([c - r[:, None], c + r[:, None]], 1)
    f[-5:] = np.nan
    return torch.from_numpy(np.ascontiguousarray(f.T.reshape(-1, T, G)))


def rays(rng, T, G):
    """(6, T, G) float32 rays from a half-integer lattice (the lattice
    boxes' face planes), a third of the direction components zero, some
    directions of equal magnitude; the last 5 rays are NaN."""
    n = T * G
    p = (np.floor(rng.random((n, 3)) * 12) / 2 - 0.5).astype(np.float32)
    d = (rng.random((n, 3)) - 0.5).astype(np.float32)
    d[rng.random((n, 3)) < 1 / 3] = 0.0
    d[: n // 8] = np.sign(d[: n // 8])
    f = np.concatenate([p, d], 1)
    f[-5:] = np.nan
    return torch.from_numpy(np.ascontiguousarray(f.T.reshape(-1, T, G)))


def field_sets(kind, G, seed, dedup=False):
    """(a_fields, b_fields) of a mask; one set (b is a) under dedup.  With
    a ray mask the first 8 rays are set against lattice leaves of the b
    set: tangent to a sphere, or lying in a box's face plane x = lo0 with
    d0 = 0 and along its face plane y = lo1."""
    rng = np.random.default_rng(seed)
    leaf = "sphere" if kind in ("sphere", "ray_sphere") else "box"
    b = leaves(rng, leaf, TB, G)
    if dedup:
        return b, b
    if not kind.startswith("ray"):
        return leaves(rng, leaf, TA, G), b
    a = rays(rng, TA, G)
    bf, af = b.reshape(b.shape[0], -1), a.view(6, -1)
    if leaf == "sphere":
        lat = torch.nonzero(bf[3] == 0.5).squeeze(1)[:8]
        c = bf[:3, lat]
        af[:3, :8] = torch.stack([c[0] - 2, c[1] + 0.5, c[2]])
        af[3:, :8] = torch.tensor([1.0, 0.0, 0.0])[:, None]
    else:
        lat = torch.nonzero(bf[3] - bf[0] == 1.0).squeeze(1)[:8]
        lo, up = bf[:3, lat], bf[3:, lat]
        af[:3, :8] = torch.stack([lo[0], lo[1] - 1, (lo[2] + up[2]) / 2])
        af[3:, :8] = torch.tensor([0.0, 1.0, 0.0])[:, None]
    return a, b


def run_inputs(G, NB, R, seed, dedup):
    """B2's run list: a_idx, run_idx (with bits above 16 set), band words
    (some slots all zero), and every nsteps case."""
    rng = np.random.default_rng(seed)
    SW = S_CAP * W
    Ta = TB if dedup else TA
    a_idx = rng.integers(0, Ta, S_CAP).astype(np.int32)
    # base 0 holds every b-tile below TB (and the diagonal); a base past
    # the last run holds b-tiles past Tb
    base = rng.integers(0, -(-TB // R) + 1, SW)
    run_idx = (base | (rng.integers(0, 64, SW) << 16)).astype(np.int32)
    words = rng.integers(0, 1 << 32, (R * NB // 32, SW), dtype=np.uint64)
    words &= rng.integers(0, 1 << 32, words.shape, dtype=np.uint64)
    words[:, rng.random(SW) < 0.2] = 0
    bm = words.astype(np.uint32).view(np.int32)
    nsteps = [0, S_CAP // 2, S_CAP + 3]
    return (torch.from_numpy(a_idx), torch.from_numpy(run_idx),
            torch.from_numpy(np.ascontiguousarray(bm)),
            [torch.tensor([n], dtype=torch.int32) for n in nsteps])


def group_inputs(seed, dedup, Ta=TA, Tb=TB):
    """B4's grouped list: a_idx (one step on a-tile Ta: dead), b_idx with
    b-tiles up to Tb (dead) and random band nibbles (some 0), and every
    nsteps case; under dedup, entries with tj < ti, tj == ti and tj > ti."""
    rng = np.random.default_rng(seed)
    SW = S_CAP * W
    a_idx = rng.integers(0, Ta, S_CAP).astype(np.int32)
    a_idx[1] = Ta
    tj = rng.integers(0, Tb + 1, SW)
    if dedup:
        tj[::3] = a_idx[np.arange(0, SW, 3) // W]     # the diagonal
    band = rng.integers(0, 16, SW)
    b_idx = (tj | (band << 16)).astype(np.int32)
    return (torch.from_numpy(a_idx), torch.from_numpy(b_idx),
            [torch.tensor([n], dtype=torch.int32)
             for n in (0, S_CAP // 2, S_CAP + 3)])


def packed_inputs(seed, Ta, Tb):
    """B6's packed list: every (ti, tj) with ti, tj up to Ta, Tb (the last
    of each dead), and npairs at 0, midway and above P_cap."""
    rng = np.random.default_rng(seed)
    ti, tj = np.meshgrid(np.arange(Ta + 1), np.arange(Tb + 1), indexing="ij")
    order = rng.permutation(ti.size)
    packed = ((ti.reshape(-1) << 16) | tj.reshape(-1))[order]
    P = packed.shape[0]
    return (torch.from_numpy(packed.astype(np.int32)),
            [torch.tensor([n], dtype=torch.int32) for n in (0, P // 2, P + 3)])


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("NB,R", [(4, 8), (8, 32), (16, 8)])
def test_run_live_pairs(NB, R):
    """run_live_pairs marks exactly the pairs a loop finds live, and the
    plain version's counts and word rows are zero outside them."""
    G = 32
    a_idx, run_idx, bm, nsteps_list = run_inputs(G, NB, R, 3, False)
    a, b = field_sets("sphere", G, 3)
    TPW = 32 // NB
    for nsteps in nsteps_list:
        live = ops.run_live_pairs(run_idx, bm, nsteps, S_CAP, TB, R=R, NB=NB)
        want = []
        for slot in range(S_CAP * W):
            for t in range(R):
                word = int(bm[t // TPW, slot]) & 0xFFFFFFFF
                bits = (word >> (NB * (t % TPW))) & ((1 << NB) - 1)
                tj = (int(run_idx[slot]) & 0xFFFF) * R + t
                want.append(bits != 0 and tj < TB and
                            slot // W < min(int(nsteps), S_CAP))
        assert live.tolist() == want
        counts, _, words = ops.tile_run_counts_plain(
            a_idx, run_idx, bm, nsteps, a, b, mask_kind="sphere", R=R, NB=NB,
            moments=True)
        assert not counts[~live].any() and not words[~live].any()
        assert int(nsteps) == 0 or counts[live].any()


@pytest.mark.parametrize("kind", MASKS)
def test_scenes_hold_their_edge_cases(kind):
    """The synthetic scenes give contacts exactly on the boundary, NaN rows
    that match nothing, and (box leaves) rays lying in a face plane with a
    zero direction component."""
    a, b = field_sets(kind, 32, 5)
    assert torch.isnan(a[:, -1, -5:]).all()
    assert torch.isnan(b[:, -1, -5:]).all()
    ai, bj = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    if kind == "sphere":
        d = ai[:3, :, None] - bj[:3, None, :]
        d2 = (d * d).sum(0)
        rr = ai[3][:, None] + bj[3][None, :]
        assert ((d2 == rr * rr) & (d2 > 0)).any()        # touching spheres
    elif kind == "box":
        assert (ai[3][:, None] == bj[0][None, :]).any()  # shared faces
    elif kind == "ray_box":
        x0, face = ai[0][:, None], (bj[0][None, :], bj[3][None, :])
        in_plane = (ai[3][:, None] == 0) & ((x0 == face[0]) | (x0 == face[1]))
        assert in_plane.any()
    else:   # tangent rays: disc == 0 for some ray and sphere
        po = ai[:3, :, None] - bj[:3, None, :]
        qa = (ai[3:] * ai[3:]).sum(0)[:, None]
        qb = 2 * (po * ai[3:, :, None]).sum(0)
        qc = (po * po).sum(0) - bj[3][None, :] ** 2
        assert ((qb * qb - 4 * qa * qc) == 0).any()


def _recorded_decode(run):
    """The count kernel's words and the moment decode's arguments of one
    run of the port on the CPU."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for module in (ttiles, tray):
            for name in ("tile_run_counts", "_moment_decode"):
                fn = getattr(module, name, None)
                if fn is None:
                    continue

                def rec(*args, _n=name, _fn=fn, **kw):
                    seen[_n] = (args, kw)
                    return _fn(*args, **kw)
                mp.setattr(module, name, rec)
        run()
    return seen


@pytest.mark.parametrize("query", ["self", "rays"])
def test_moment_decode_reads_only_live_rows(query):
    """The decode's stream does not change when every word row outside the
    live pairs holds garbage: the card may leave those rows unwritten."""
    rng = np.random.default_rng(7)
    xs = (rng.random((700, 3)) * 6).astype(np.float32)
    rs = (rng.random(700) * 0.3 + 0.2).astype(np.float32)
    bvh = tb.build(tb.BSphere(xs, rs, device="cpu"))
    alg = tb.TileTraversal(tile=32, row_cap=16, pair_cap=128, count_w=2,
                           emit_w=2, decode_k=8)
    if query == "self":
        seen = _recorded_decode(
            lambda: tb.traverse_tiles_fixed(bvh, 4096, alg=alg))
    else:
        p = (rng.random((3, 200)) * 6).astype(np.float32)
        d = (rng.random((3, 200)) - 0.5).astype(np.float32)
        seen = _recorded_decode(lambda: tb.traverse_rays_tiles_fixed(
            bvh, p, d, 4096, alg=alg))
    (a_idx, run_idx, bm, nsteps, *fields), kw = seen["tile_run_counts"]
    dargs, dkw = seen["_moment_decode"]
    words = dargs[0]
    live = ops.run_live_pairs(run_idx, bm, nsteps, a_idx.shape[0],
                              fields[-1].shape[1], R=kw["R"], NB=kw["NB"])
    assert live.any() and not live.all()
    garbage = words.clone()
    garbage[~live] = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (int((~live).sum()), words.shape[1]),
        dtype=np.int64).astype(np.int32))
    gi, gj, total = ttiles._moment_decode(words, *dargs[1:], **dkw)
    ggi, ggj, gtotal = ttiles._moment_decode(garbage, *dargs[1:], **dkw)
    n = int(total)
    assert n > 0 and int(gtotal) == n
    assert torch.equal(gi[:n], ggi[:n]) and torch.equal(gj[:n], ggj[:n])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *ts):
    return tuple(t.to(dev) for t in ts)


def _fields_on(dev, dtype, a, b):
    """A field set pair on ``dev`` in ``dtype``; one set stays one."""
    a2 = a.to(dev, dtype)
    return a2, (a2 if b is a else b.to(dev, dtype))


RUN_SHAPES = [
    (G, NB, R) for G in (32, 64, 128) for NB in (4, 8, 16) for R in (8, 32)
] + [(96, 4, 8), (96, 16, 32), (256, 4, 8), (256, 8, 32), (800, 16, 8),
     (1024, 4, 8), (1024, 8, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("G,NB,R", RUN_SHAPES)
def test_run_counts_match_plain_on_card(cuda, G, NB, R):
    """B2 equals its plain version: counts, colmax and, with moments, the
    word rows of the live pairs; every mask, one and two field sets,
    dedup on the diagonal, every nsteps case."""
    _check_run_counts(cuda, G, NB, R, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("G,NB,R", [(32, 4, 8), (64, 8, 32), (96, 16, 32),
                                    (128, 4, 8), (128, 16, 8), (256, 8, 32),
                                    (800, 16, 8), (1024, 4, 8)])
def test_run_counts_match_plain_on_card_float64(cuda, G, NB, R):
    """B2's double kernel equals its plain version, as in float32."""
    _check_run_counts(cuda, G, NB, R, torch.float64)


def _check_run_counts(cuda, G, NB, R, dtype):
    cases = [(k, False) for k in MASKS] + [("sphere", True), ("box", True)]
    for kind, dedup in cases:
        a, b = _fields_on(cuda, dtype, *field_sets(kind, G, G + NB + R,
                                                   dedup))
        a_idx, run_idx, bm, nsteps_list = run_inputs(G, NB, R, G * R + NB,
                                                     dedup)
        a_idx, run_idx, bm = _on(cuda, a_idx, run_idx, bm)
        for nsteps in nsteps_list:
            nsteps = nsteps.to(cuda)
            for moments in (False, True) if G <= 128 else (False,):
                args = (a_idx, run_idx, bm, nsteps, a, None if dedup else b)
                kw = dict(mask_kind=kind, R=R, NB=NB, dedup=dedup,
                          moments=moments)
                got = ops.tile_run_counts(*args, **kw)
                want = ops.tile_run_counts_plain(*args, **kw)
                torch.cuda.synchronize()
                label = (kind, dedup, int(nsteps), moments)
                assert torch.equal(got[0], want[0]), label
                assert torch.equal(got[1], want[1]), label
                if moments:
                    live = ops.run_live_pairs(run_idx, bm, nsteps, S_CAP,
                                              b.shape[1], R=R, NB=NB)
                    assert torch.equal(got[2][live], want[2][live]), label


def _slots_equal(got, want, CAP_PAIR):
    gi, gj, c, o = got
    pgi, pgj, pc, po = want
    below = torch.arange(CAP_PAIR, device=pc.device)[None, :] < \
        pc.clamp(max=CAP_PAIR)[:, None]
    return (torch.equal(c, pc) and bool(o) == bool(po)
            and torch.equal(gi[below], pgi[below])
            and torch.equal(gj[below], pgj[below]))


@pytest.mark.gpu
@pytest.mark.parametrize("G", [32, 64, 96, 128, 256, 800, 1024])
def test_slot_kernels_match_plain_on_card(cuda, G):
    """B4 (grouped) and B6 (packed) equal their plain versions: counts, the
    overflow flag and every lane below min(count, CAP_PAIR); every mask,
    one and two field sets, dedup on the diagonal, dead steps, entries and
    bands, every nsteps / npairs case, with and without slot overflow."""
    _check_slot_kernels(cuda, G, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [32, 64, 96, 128, 256, 800, 1024])
def test_slot_kernels_match_plain_on_card_float64(cuda, G):
    """B4 and B6's double kernels equal their plain versions, as in
    float32 (128 KB of records a block at tile 1024)."""
    _check_slot_kernels(cuda, G, torch.float64)


def _check_slot_kernels(cuda, G, dtype):
    cases = [(k, False) for k in MASKS] + [("sphere", True), ("box", True)]
    for kind, dedup in cases:
        a, b = _fields_on(cuda, dtype, *field_sets(kind, G, 3 * G, dedup))
        Ta = a.shape[1]
        a_idx, b_idx, nsteps_list = group_inputs(G, dedup, Ta=Ta)
        a_idx, b_idx = _on(cuda, a_idx, b_idx)
        packed, npairs_list = packed_inputs(G + 1, Ta, TB)
        packed = packed.to(cuda)
        for row_cap, cap_pair in ((4, 16), (64, 1024)):
            kw = dict(mask_kind=kind, ROW_CAP=row_cap, CAP_PAIR=cap_pair,
                      dedup=dedup)
            fs = (a, None if dedup else b)
            for nsteps in nsteps_list:
                nsteps = nsteps.to(cuda)
                assert _slots_equal(
                    ops.tile_group_contacts(a_idx, b_idx, nsteps, *fs, **kw),
                    ops.tile_group_contacts_plain(a_idx, b_idx, nsteps, *fs,
                                                  **kw), cap_pair), \
                    (kind, dedup, int(nsteps), row_cap)
            for npairs in npairs_list:
                npairs = npairs.to(cuda)
                assert _slots_equal(
                    ops.tile_pair_contacts(packed, npairs, *fs, **kw),
                    ops.tile_pair_contacts_plain(packed, npairs, *fs, **kw),
                    cap_pair), (kind, dedup, int(npairs), row_cap)
