"""Two-tree tile traversal of the port against the JAX package, on the CPU.

Two sphere (or box) sets, made by numpy from seeds, are built into BVHs by
both packages and go through ``traverse_tiles_pair_fixed`` on both routes
(the JAX package's Pallas kernels in interpret mode, the port's kernels as
their plain PyTorch versions), through the cross forms of phase 1
(``_phase1_superpairs`` then ``_slice_runs``, and ``_phase1_tile_pairs``,
with a second tile set,
against the JAX package's ``_phase1_cross_runs`` and
``_phase1_cross_pairs``), and
through the growth wrapper ``traverse_tiles_pair``.

Tolerance: exact.  The total, the overflow bits, ``num_checks`` and every
phase-1 output must be equal.  The contact rows are ``(index in bvh1,
index in bvh2)`` pairs in emit order: on the fallback the order is fixed by
the slot layout and the rows are compared row by row; on the two-phase
route the emit kernel's order inside a tile pair differs between the
packages (column-major in the port's kernels, cursor order in the Pallas
kernel), so there the rows are compared as sorted lists, as the
self-contact tests do.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.traverse import tiles as jtiles
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import interop
from implicitbvh_tpu_torch.traverse import tiles as ttiles

CPU = torch.device("cpu")


def spheres(n, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 3), dtype=np.float32) * scale
    rs = (rng.random(n, dtype=np.float32) * 0.4 + 0.05).astype(np.float32)
    return xs, rs


def brute_force_pair(xs1, rs1, xs2, rs2, box=False):
    """1-based (i, j) of every contact of set 1 with set 2, in float32 in
    the kernels' operation order."""
    if box:
        lo1, up1, lo2, up2 = xs1 - rs1[:, None], xs1 + rs1[:, None], \
            xs2 - rs2[:, None], xs2 + rs2[:, None]
        hit = ((up1[:, None] >= lo2[None]) & (lo1[:, None] <= up2[None])) \
            .all(-1)
    else:
        d = [xs1[:, None, k] - xs2[None, :, k] for k in range(3)]
        rr = rs1[:, None] + rs2[None, :]
        hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
    return {(int(i) + 1, int(j) + 1) for i, j in zip(*np.nonzero(hit))}


def needs_jax():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def build_both(xs, rs, box=False, node_kind="box"):
    """(JAX BVH, port BVH) over the same spheres, or their boxes."""
    needs_jax()
    if box:
        jv = jb.BBox(jnp.asarray(xs - rs[:, None]),
                     jnp.asarray(xs + rs[:, None]))
        tv = tb.BBox(torch.from_numpy(xs - rs[:, None]),
                     torch.from_numpy(xs + rs[:, None]))
    else:
        jv = jb.BSphere(jnp.asarray(xs), jnp.asarray(rs))
        tv = tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))
    jk, tk = (jb.BSphere, tb.BSphere) if node_kind == "sphere" \
        else (jb.BBox, tb.BBox)
    return jb.build(jv, jk), tb.build(tv, tk)


def to_port(jbvh):
    """The JAX package's BVH, as numpy arrays, in the port."""
    vol, nodes = jbvh.leaves.volume, jbvh.nodes
    d = {"index": np.asarray(jbvh.leaves.index),
         "morton": np.asarray(jbvh.leaves.morton),
         "skips": np.asarray(jbvh.skips), "built_level": jbvh.built_level,
         "num_leaves": jbvh.num_leaves}
    if isinstance(vol, jb.BSphere):
        d["leaf_kind"], d["leaf_r"] = "sphere", np.asarray(vol.r)
    else:
        d["leaf_kind"] = "box"
    if isinstance(nodes, jb.BSphere):
        d["node_r"] = np.asarray(nodes.r)
    for k in range(3):
        if isinstance(vol, jb.BSphere):
            d[f"leaf_x{k}"] = np.asarray(vol.xs[k])
        else:
            d[f"leaf_lo{k}"] = np.asarray(vol.los[k])
            d[f"leaf_up{k}"] = np.asarray(vol.ups[k])
        if isinstance(nodes, jb.BSphere):
            d[f"node_x{k}"] = np.asarray(nodes.xs[k])
        else:
            d[f"node_lo{k}"] = np.asarray(nodes.los[k])
            d[f"node_up{k}"] = np.asarray(nodes.ups[k])
    return interop.bvh_from_numpy(d, CPU)


def rows(contacts, total):
    return [tuple(r) for r in np.asarray(contacts)[:int(total)].tolist()]


def summary(out, ordered):
    t, c, o, nc = out
    r = rows(c, t)
    return (r if ordered else sorted(r), int(t), int(o), float(nc))


# (n1, seed1, n2, seed2, box leaves, traversal parameters, capacity,
#  rows compared in order)
TWO_PHASE = dict(tile=32, row_cap=16, pair_cap=128, count_w=2, emit_w=2)
FALLBACK = dict(tile=32, row_cap=16, pair_cap=256, count_w=2)
CASES = {
    "two_phase": (150, 41, 90, 42, False, TWO_PHASE, 1024, False),
    "fallback": (150, 41, 90, 42, False, FALLBACK, 1024, True),
    "fallback_small_capacity": (150, 41, 90, 42, False,
                                dict(tile=32, row_cap=16, pair_cap=128,
                                     count_w=2), 1000, True),
    "bands16": (300, 12, 90, 13, False, dict(bands=16, **TWO_PHASE), 1024,
                False),
    "box_leaves": (150, 41, 90, 42, True, TWO_PHASE, 1024, False),
    "bvh2_larger": (90, 42, 150, 41, False, TWO_PHASE, 1024, False),
    "one_leaf_bvh1": (1, 7, 90, 42, False, FALLBACK, 1024, True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    n1, s1, n2, s2, box, params, capacity, ordered = CASES[request.param]
    xs1, rs1 = spheres(n1, s1)
    xs2, rs2 = spheres(n2, s2)
    if n1 == 1:
        xs1, rs1 = np.full((1, 3), 2.5, np.float32), \
            np.array([1.5], np.float32)
    j1, t1 = build_both(xs1, rs1, box)
    j2, t2 = build_both(xs2, rs2, box)
    want = summary(jtiles.traverse_tiles_pair_fixed(
        j1, j2, capacity, alg=jb.TileTraversal(**params)), ordered)
    got = summary(tb.traverse_tiles_pair_fixed(
        t1, t2, capacity, alg=tb.TileTraversal(**params)), ordered)
    bf = brute_force_pair(xs1, rs1, xs2, rs2, box)
    return request.param, want, got, bf, (j1, j2, params, capacity, ordered)


def test_pair_fixed_matches_jax_and_brute_force(case):
    _, want, got, bf, _ = case
    assert got == want
    pairs, total, overflow, _ = got
    assert overflow == 0 and total > 0
    assert set(pairs) == bf and len(pairs) == total == len(bf)


def test_pair_fixed_on_the_jax_bvhs(case):
    """The JAX package's two BVHs carried across give the same result
    through the port's traversal: build and traversal agree separately."""
    _, want, _, _, (j1, j2, params, capacity, ordered) = case
    got = summary(tb.traverse_tiles_pair_fixed(
        to_port(j1), to_port(j2), capacity,
        alg=tb.TileTraversal(**params)), ordered)
    assert got == want


@pytest.mark.parametrize("route", ["two_phase", "fallback"])
def test_pair_narrow_matches_jax(route):
    def narrow(l1, l2):
        return (l1.index * 3 + l2.index) % 4 != 0

    n1, s1, n2, s2, _, params, capacity, ordered = CASES[route]
    xs1, rs1 = spheres(n1, s1)
    xs2, rs2 = spheres(n2, s2)
    j1, t1 = build_both(xs1, rs1)
    j2, t2 = build_both(xs2, rs2)
    want = summary(jtiles.traverse_tiles_pair_fixed(
        j1, j2, capacity, alg=jb.TileTraversal(**params), narrow=narrow),
        ordered)
    got = summary(tb.traverse_tiles_pair_fixed(
        t1, t2, capacity, alg=tb.TileTraversal(**params), narrow=narrow),
        ordered)
    assert got == want and got[2] == 0
    assert set(got[0]) == {(i, j) for i, j in brute_force_pair(
        xs1, rs1, xs2, rs2) if (i * 3 + j) % 4}


def test_pair_self_includes_diagonal_and_both_orders():
    """``traverse_tiles_pair_fixed(bvh, bvh)`` holds every (i, i) and both
    orders of every self-contact pair."""
    xs, rs = spheres(150, 41)
    bvh = tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))
    alg = tb.TileTraversal(**TWO_PHASE)
    t, c, o, _ = tb.traverse_tiles_pair_fixed(bvh, bvh, 2048, alg=alg)
    pair = set(rows(c, t))
    ts, cs, os_, _ = tb.traverse_tiles_fixed(bvh, 1024, alg=alg)
    single = set(rows(cs, ts))
    assert int(o) == int(os_) == 0 and len(pair) == int(t)
    assert {(i, i) for i in range(1, 151)} <= pair
    assert {(min(i, j), max(i, j)) for i, j in pair if i != j} == single
    assert {(j, i) for i, j in pair} == pair


@pytest.mark.parametrize("route", ["two_phase", "fallback"])
def test_pair_dense_scene_overflow_bits_match_jax(route):
    """Dense clusters overflow the slot caps; both packages report the
    same overflow bits, total and ``num_checks``."""
    needs_jax()
    xs1, rs1 = spheres(96, 5, 0.8)
    xs2, rs2 = spheres(64, 6, 0.8)
    params = dict(tile=32, row_cap=2, pair_cap=4, count_w=2, emit_w=2)
    capacity = 1024 if route == "two_phase" else 1000
    j1, t1 = build_both(xs1, rs1)
    j2, t2 = build_both(xs2, rs2)
    jout = jtiles.traverse_tiles_pair_fixed(j1, j2, capacity,
                                        alg=jb.TileTraversal(**params))
    tout = tb.traverse_tiles_pair_fixed(t1, t2, capacity,
                                        alg=tb.TileTraversal(**params))
    assert int(jout[2]) == int(tout[2]) and int(tout[2]) & 2
    assert int(jout[0]) == int(tout[0])
    assert float(jout[3]) == float(tout[3])


def tiled(jbvh, tbvh, G, NB):
    jf = jtiles._tiled_fields(jbvh, G, NB)
    tf = ttiles._tiled_fields(tbvh, G, NB)
    return jf, tf


@pytest.fixture(scope="module")
def phase1_scene():
    """T1 = 24 and T2 = 40 tiles of 32: one supertile against two."""
    xs1, rs1 = spheres(760, 21, 9.0)
    xs2, rs2 = spheres(1270, 22, 9.0)
    return build_both(xs1, rs1), build_both(xs2, rs2)


@pytest.mark.parametrize("NB", [4, 16])
def test_phase1_cross_runs_matches_jax(phase1_scene, NB):
    (j1, t1), (j2, t2) = phase1_scene
    G, P_cap, W, R = 32, 8192, 2, 8
    (_, _, jlo1, jup1, jslo, jsup, T1), (_, _, ttiles1, tsub1, _) = \
        tiled(j1, t1, G, NB)
    (_, _, jlo2, jup2, _, _, T2), (_, _, ttiles2, _, _) = tiled(j2, t2, G, 4)
    assert (T1, T2) == (24, 40)
    S_cap, _ = jtiles._step_caps(P_cap // W + T1)
    pad_run = -(-T2 // R)
    want = jtiles._phase1_cross_runs(jlo1, jup1, jslo, jsup, jlo2, jup2, G,
                                     P_cap, W, S_cap, R, pad_run, NB,
                                     interpret=True)
    si, sj, nsp, sp_ov = ttiles._phase1_superpairs(ttiles1, P_cap, ttiles2)
    ta, tr, tbm, tn, tnc, run_ov = ttiles._slice_runs(
        tsub1, ttiles2, si, sj, nsp.clamp(max=si.shape[0]), G, W, S_cap, R,
        pad_run, NB, triangle=False)
    tov = sp_ov | run_ov
    ja, jr, jbm, jn, jnc, jov = want
    n = int(tn)
    assert n == int(jn) > 0 and bool(tov) == bool(jov) is False
    assert float(tnc) == float(jnc)
    # steps past nsteps hold pads that no kernel reads
    assert np.array_equal(np.asarray(ja)[:n], ta.numpy()[:n])
    assert np.array_equal(np.asarray(jr)[:n * W], tr.numpy()[:n * W])
    assert np.array_equal(np.stack([np.asarray(w) for w in jbm])[:, :n * W],
                          tbm.numpy()[:, :n * W])
    assert int((tr[:n * W] != pad_run).sum()) > 0


def test_phase1_cross_pairs_matches_jax(phase1_scene):
    (j1, t1), (j2, t2) = phase1_scene
    G, P_cap = 32, 8192
    (_, _, jlo1, jup1, jslo, jsup, _), (_, _, ttiles1, tsub1, _) = \
        tiled(j1, t1, G, 8)       # 8 bands, folded to the fallback's 4
    (_, _, jlo2, jup2, _, _, _), (_, _, ttiles2, _, _) = tiled(j2, t2, G, 4)
    jp, jband, jn = jtiles._phase1_cross_pairs(jlo1, jup1, jslo, jsup, jlo2,
                                               jup2, G, P_cap, interpret=True)
    tp, tband, tn = ttiles._phase1_tile_pairs(ttiles1, tsub1, P_cap,
                                              tiles_b=ttiles2)
    n = int(tn)
    assert n == int(jn) > 0
    assert np.array_equal(np.asarray(jp)[:n], tp.numpy()[:n])
    assert np.array_equal(np.asarray(jband)[:n], tband.numpy()[:n])


def test_phase1_cross_pairs_overflow_sets_npairs():
    """More overlapping tile pairs than the pair capacity: ``npairs`` is
    ``P_cap + 1`` or the true count, above ``P_cap`` either way, and the
    fixed path reports overflow bit 0."""
    xs1, rs1 = spheres(760, 21, 1.5)
    xs2, rs2 = spheres(1270, 22, 1.5)
    t1 = tb.build(tb.BSphere(torch.from_numpy(xs1), torch.from_numpy(rs1)))
    t2 = tb.build(tb.BSphere(torch.from_numpy(xs2), torch.from_numpy(rs2)))
    _, _, tl1, sub1, _ = ttiles._tiled_fields(t1, 32, 4)
    _, _, tl2, _, _ = ttiles._tiled_fields(t2, 32, 4)
    _, _, n = ttiles._phase1_tile_pairs(tl1, sub1, 64, tiles_b=tl2)
    assert int(n) > 64
    out = tb.traverse_tiles_pair_fixed(t1, t2, 1000, pair_capacity=64,
                                       alg=tb.TileTraversal(tile=32))
    assert int(out[2]) & 1


def test_growth_wrapper_and_cache_match_jax():
    """Slot-cap and capacity growth end, in both packages, with the same
    contacts, capacities and grown caps; a repeat with ``cache=`` starts
    from them."""
    needs_jax()
    xs1, rs1 = spheres(200, 5, 3.0)
    xs2, rs2 = spheres(120, 6, 3.0)
    params = dict(tile=32, row_cap=2, pair_cap=4, count_w=2, emit_w=2)
    j1, t1 = build_both(xs1, rs1)
    j2, t2 = build_both(xs2, rs2)
    jt = jtiles.traverse_tiles_pair(j1, j2, alg=jb.TileTraversal(**params),
                                options=jb.BVHOptions(min_capacity=1024))
    tt = tb.traverse_tiles_pair(t1, t2, alg=tb.TileTraversal(**params),
                                options=tb.BVHOptions(min_capacity=1024))
    assert sorted(tt.contacts_list()) == sorted(jt.contacts_list())
    assert set(tt.contacts_list()) == brute_force_pair(xs1, rs1, xs2, rs2)
    assert (tt.tile_alg.row_cap, tt.tile_alg.pair_cap) == \
        (jt.tile_alg.row_cap, jt.tile_alg.pair_cap)
    assert tt.tile_alg.pair_cap > 4
    assert tt.num_checks == jt.num_checks
    assert tt.pair_capacity == jt.pair_capacity
    assert tuple(tt.cache1.shape) == tuple(jt.cache1.shape)
    assert (tt.start_level1, tt.start_level2) == \
        (jt.start_level1, jt.start_level2)
    again = tb.traverse_tiles_pair(t1, t2, alg=tb.TileTraversal(**params),
                                   cache=tt)
    assert again.tile_alg == tt.tile_alg
    assert tuple(again.cache1.shape) == tuple(tt.cache1.shape)
    assert sorted(again.contacts_list()) == sorted(tt.contacts_list())


def test_wrapper_starting_capacity():
    """The pair wrapper starts from twice the larger leaf count rounded up
    to a power of two, and from the pair capacity of the mean tile count."""
    xs1, rs1 = spheres(700, 1, 9.0)
    xs2, rs2 = spheres(300, 2, 9.0)
    t1 = tb.build(tb.BSphere(torch.from_numpy(xs1), torch.from_numpy(rs1)))
    t2 = tb.build(tb.BSphere(torch.from_numpy(xs2), torch.from_numpy(rs2)))
    t = tb.traverse_tiles_pair(t1, t2, alg=tb.TileTraversal(tile=32))
    assert t.cache1.shape[0] == 2048 and t.pair_capacity == 8192
    assert set(t.contacts_list()) == brute_force_pair(xs1, rs1, xs2, rs2)


def test_mixed_leaf_kinds_raise_on_the_tile_engine():
    xs, rs = spheres(64, 0)
    a = tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))
    b = tb.build(tb.BBox(torch.from_numpy(xs - rs[:, None]),
                         torch.from_numpy(xs + rs[:, None])))
    with pytest.raises(NotImplementedError, match="LVTTraversal"):
        tb.traverse_tiles_pair_fixed(a, b, 1024)


def test_growth_end_takes_the_walk():
    """One tile pair with more contacts than ``MAX_PAIR_CAP``: growth ends
    in the leaf-vs-tree walk, for one BVH and for two (it used to raise)."""
    n = 40
    xs = np.zeros((n, 3), np.float32)
    rs = np.full(n, 0.5, np.float32)
    bvh = tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))
    alg = tb.TileTraversal(tile=64)
    assert n * n > ttiles.MAX_PAIR_CAP
    t = tb.traverse_tiles_pair(bvh, bvh, alg=alg)
    assert t.tile_alg is None and t.num_contacts == n * n
    assert set(t.contacts_list()) == {(i, j) for i in range(1, n + 1)
                                      for j in range(1, n + 1)}
    n = 48            # 48 * 47 / 2 = 1128 self pairs in one tile
    xs = np.zeros((n, 3), np.float32)
    rs = np.full(n, 0.5, np.float32)
    bvh = tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))
    t = tb.traverse_tiles(bvh, alg=alg)
    assert t.tile_alg is None and t.num_contacts == n * (n - 1) // 2
    assert set(t.contacts_list()) == {(i, j) for i in range(1, n + 1)
                                      for j in range(i + 1, n + 1)}


@pytest.mark.gpu
def test_pair_slice_on_card_matches_cpu():
    """Two-tree traversal on the card (CUDA kernels) equals the port on the
    CPU (plain versions), on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    xs1, rs1 = spheres(5000, 1, 17.0)
    xs2, rs2 = spheres(3000, 2, 17.0)
    for params, capacity in ((dict(tile=32), 4096),
                             (dict(tile=32, row_cap=16, pair_cap=256), 4096)):
        res = []
        for dev in ("cuda", "cpu"):
            b1 = tb.build(tb.BSphere(xs1, rs1, device=dev))
            b2 = tb.build(tb.BSphere(xs2, rs2, device=dev))
            t, c, o, nc = tb.traverse_tiles_pair_fixed(
                b1, b2, capacity, alg=tb.TileTraversal(**params))
            res.append((sorted(rows(c.cpu(), t)), int(t), int(o), float(nc)))
        assert res[0] == res[1] and res[0][2] == 0 and res[0][1] > 0
