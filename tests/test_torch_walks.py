"""The port's leaf-vs-tree walks and ``traverse`` dispatch against the JAX
package, on the CPU.

The scenes of ``tests/test_traverse_pair.py`` (spheres made by numpy from a
seed) go through ``traverse`` of both packages; the stackless walk's count
pass and write pass are held against the JAX package's lane by lane for
self-contact, two trees and rays.  Tolerance: exact.  Per-lane counts,
offsets, totals and the output rows in order must be equal: the walk
visits a lane's leaves in tree order and writes at scanned offsets, so its
output order is fixed.
"""

import warnings

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import raytrace as jray
    from implicitbvh_tpu.traverse import lvt as jlvt
    from implicitbvh_tpu.traverse import traverse as jtraverse
    from implicitbvh_tpu.utils import count_trailing_zeros as jax_ctz
    from implicitbvh_tpu.utils import floor_ilog2 as jax_ilog2
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import raytrace as tray
from implicitbvh_tpu_torch import tracing
from implicitbvh_tpu_torch import utils as tutils
from implicitbvh_tpu_torch.traverse import lvt as tlvt
from implicitbvh_tpu_torch.traverse import walk as twalk
from implicitbvh_tpu_torch.tree import (ImplicitTree, isvirtual_lanes,
                                        memory_index_lanes)

from test_torch_pair import brute_force_pair, build_both, spheres, to_port


@pytest.fixture(autouse=True)
def reference_or_card(request):
    """All but the ``gpu`` cases compare with the JAX package."""
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def brute_force_self(xs, rs):
    return {(i, j) for i, j in brute_force_pair(xs, rs, xs, rs) if i < j}


def test_bit_helpers_match_jax():
    v = np.concatenate([np.arange(1, 70), 2 ** np.arange(1, 31) - 1,
                        2 ** np.arange(1, 31),
                        [2 ** 31 - 1, 2 ** 24 + 1, 2 ** 25 - 1]])
    v = v.astype(np.int32)
    t = torch.from_numpy(v)
    assert eq(jax_ilog2(jnp.asarray(v)), tutils.floor_ilog2(t))
    assert eq(jax_ctz(jnp.asarray(v)), tutils.count_trailing_zeros(t))
    assert tutils.floor_ilog2(t).dtype == torch.int32
    assert tutils.trailing_ones(torch.tensor([0, 1, 2, 3, 7, 11])).tolist() \
        == [0, 1, 0, 2, 3, 2]
    big = torch.tensor([2 ** 40 + 5, 2 ** 52], dtype=torch.int64)
    assert tutils.floor_ilog2(big).tolist() == [40, 52]


@pytest.mark.parametrize("n", [1, 5, 100, 1025])
def test_lane_tree_queries(n):
    tree = ImplicitTree.from_num_leaves(n)
    k = torch.arange(1, 1 << tree.levels, dtype=torch.int32)
    virt = isvirtual_lanes(tree, k)
    assert virt.tolist() == [tree.isvirtual(int(i)) for i in k]
    real = k[~virt]
    skips = torch.from_numpy(tree.skips_np())
    assert memory_index_lanes(tree, real, skips).tolist() == \
        [tree.memory_index(int(i)) for i in real]


# (leaves, seed, node kind, start level, narrow)
SINGLE = {
    "bbox_nodes": (80, 11, "box", 1, False),
    "bsphere_nodes": (150, 7, "sphere", 1, False),
    "start_level_3": (64, 0, "box", 3, False),
    "leaf_level": (33, 15, "box", 7, False),
    "narrow": (80, 11, "box", 1, True),
}


def narrow_even(l1, l2):
    return (l1.index + l2.index) % 2 == 0


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_walk_single_matches_jax(name):
    n, seed, kind, sl, with_narrow = SINGLE[name]
    xs, rs = spheres(n, seed)
    jbvh, tbvh = build_both(xs, rs, node_kind=kind)
    narrow = narrow_even if with_narrow else None
    jc = jlvt.lvt_count_single(jbvh, sl, narrow)
    tc = tlvt.lvt_count_single(tbvh, sl, narrow)
    assert eq(jc, tc) and int(tc.sum()) > 0
    off = np.cumsum(np.asarray(jc)) - np.asarray(jc)
    jout = jlvt.lvt_write_single(jbvh, jnp.asarray(off), sl, 1024, narrow)
    tout = tlvt.lvt_write_single(tbvh, torch.from_numpy(off), sl, 1024,
                                 narrow)
    assert eq(jout, tout)
    total, fixed = tb.traverse_lvt_single_fixed(tbvh, 1024, start_level=sl,
                                                narrow=narrow)
    assert int(total) == int(tc.sum()) and torch.equal(fixed, tout)
    bf = brute_force_self(xs, rs)
    if with_narrow:
        bf = {(i, j) for i, j in bf if (i + j) % 2 == 0}
    assert {tuple(r) for r in tout[:int(total)].tolist()} == bf


# (leaves 1, seed 1, leaves 2, seed 2, node kind, start levels, narrow)
PAIR = {
    "50x70": (50, 0, 70, 1, "box", (1, 1), False),
    "70x50": (70, 2, 50, 3, "box", (1, 1), False),
    "5x100": (5, 4, 100, 5, "box", (1, 1), False),
    "bsphere_nodes_flip": (10, 6, 150, 7, "sphere", (1, 1), False),
    "start_levels": (64, 0, 40, 9, "box", (3, 2), False),
    "narrow": (40, 13, 60, 14, "box", (1, 1), True),
    "narrow_flip": (60, 14, 40, 13, "box", (1, 1), True),
}


@pytest.mark.parametrize("name", sorted(PAIR))
def test_walk_pair_matches_jax(name):
    n1, s1, n2, s2, kind, (sl1, sl2), with_narrow = PAIR[name]
    xs1, rs1 = spheres(n1, s1)
    xs2, rs2 = spheres(n2, s2)
    j1, t1 = build_both(xs1, rs1, node_kind=kind)
    j2, t2 = build_both(xs2, rs2, node_kind=kind)
    narrow = narrow_even if with_narrow else None
    jt = jtraverse(j1, j2, jb.LVTTraversal(), start_level1=sl1,
                   start_level2=sl2, narrow=narrow)
    tt = tb.traverse(t1, t2, tb.LVTTraversal(), start_level1=sl1,
                     start_level2=sl2, narrow=narrow)
    assert tt.num_contacts == int(jt.num_contacts) > 0
    assert eq(jt.cache1, tt.cache1) and eq(jt.cache2, tt.cache2)
    assert (tt.start_level1, tt.start_level2) == (sl1, sl2)
    bf = brute_force_pair(xs1, rs1, xs2, rs2)
    if with_narrow:
        bf = {(i, j) for i, j in bf if (i + j) % 2 == 0}
    assert set(tt.contacts_list()) == bf
    jtot, jout = jlvt.traverse_lvt_pair_fixed(j1, j2, 1024, narrow=narrow)
    ttot, tout = tb.traverse_lvt_pair_fixed(t1, t2, 1024, narrow=narrow)
    assert int(jtot) == int(ttot) and eq(jout, tout)
    # the JAX package's BVHs carried across walk the same
    ctot, cout = tb.traverse_lvt_pair_fixed(to_port(j1), to_port(j2), 1024,
                                            narrow=narrow)
    assert int(ctot) == int(ttot) and torch.equal(cout, tout)


@pytest.mark.parametrize("name", ["50x70", "bsphere_nodes_flip"])
def test_dfs_pair_takes_the_walk_as_jax(name):
    """Two trees under ``DFSTraversal()`` walk from DFS's deep default start
    levels in both packages: the same rows in order and the same levels."""
    n1, s1, n2, s2, kind, _, _ = PAIR[name]
    xs1, rs1 = spheres(n1, s1)
    xs2, rs2 = spheres(n2, s2)
    j1, t1 = build_both(xs1, rs1, node_kind=kind)
    j2, t2 = build_both(xs2, rs2, node_kind=kind)
    jt = jtraverse(j1, j2, jb.DFSTraversal())
    tt = tb.traverse(t1, t2, tb.DFSTraversal())
    assert tt.num_contacts == int(jt.num_contacts) > 0
    assert eq(jt.cache1, tt.cache1) and eq(jt.cache2, tt.cache2)
    assert (tt.start_level1, tt.start_level2) == \
        (jt.start_level1, jt.start_level2) == \
        (tb.default_start_level(t1, tb.DFSTraversal()),
         tb.default_start_level(t2, tb.DFSTraversal()))
    assert tt.start_level1 > 1
    assert set(tt.contacts_list()) == brute_force_pair(xs1, rs1, xs2, rs2)


def test_pair_contact_order_is_tree_order():
    xs1, rs1 = np.array([[0, 0, 0.0]], np.float32), np.array([1.0], np.float32)
    xs2 = np.array([[0, 0, 0.5], [9, 9, 9.0]], np.float32)
    rs2 = np.array([1.0, 0.1], np.float32)
    b1 = tb.build(tb.BSphere(xs1, rs1, device="cpu"))
    b2 = tb.build(tb.BSphere(xs2, rs2, device="cpu"))
    assert tb.traverse(b1, b2).contacts_list() == [(1, 1)]
    assert tb.traverse(b2, b1).contacts_list() == [(1, 1)]
    assert tb.traverse(b1, b2, tb.TileTraversal()).contacts_list() == [(1, 1)]


def test_pair_single_leaf_tree():
    xs1, rs1 = np.array([[2.0, 2.0, 2.0]], np.float32), \
        np.array([1.5], np.float32)
    xs2, rs2 = spheres(33, 15)
    j1, t1 = build_both(xs1, rs1)
    j2, t2 = build_both(xs2, rs2)
    want = jtraverse(j1, j2, jb.LVTTraversal())
    for a, b, flip in ((t1, t2, False), (t2, t1, True)):
        t = tb.traverse(a, b)
        got = {(j, i) for i, j in t.contacts_list()} if flip \
            else set(t.contacts_list())
        assert got == brute_force_pair(xs1, rs1, xs2, rs2)
    assert eq(want.cache1, tb.traverse(t1, t2).cache1)


def test_self_consistency_single_vs_pair():
    xs, rs = spheres(80, 11)
    bvh = tb.build(tb.BSphere(xs, rs, device="cpu"))
    single = set(tb.traverse(bvh).contacts_list())
    pair = set(tb.traverse(bvh, bvh).contacts_list())
    assert {(min(i, j), max(i, j)) for i, j in pair if i != j} == single
    assert {(i, i) for i in range(1, 81)} <= pair
    assert single == brute_force_self(xs, rs)


def test_mixed_leaf_kinds_take_the_walk():
    """A sphere-leaf BVH against a box-leaf BVH: the default is the walk,
    and the test goes through the spheres' boxes."""
    xs1, rs1 = spheres(70, 2)
    xs2, rs2 = spheres(50, 3)
    j1, t1 = build_both(xs1, rs1)
    j2, t2 = build_both(xs2, rs2, box=True)
    assert isinstance(tb.traverse.__globals__["_default_algorithm"](t1, t2),
                      tb.LVTTraversal)
    jt = jtraverse(j1, j2, jb.LVTTraversal())
    tt = tb.traverse(t1, t2)
    assert eq(jt.cache1, tt.cache1) and tt.num_contacts == int(jt.num_contacts)
    assert set(tt.contacts_list()) == brute_force_pair(xs1, rs1, xs2, rs2,
                                                       box=True)


def test_traverse_on_cpu_takes_lvt_and_equals_tiles():
    xs, rs = spheres(300, 12, 6.0)
    jbvh, tbvh = build_both(xs, rs)
    t = tb.traverse(tbvh)
    assert t.tile_alg is None and t.cache2.shape[0] == 300   # the walk's
    tiles = tb.traverse_tiles(tbvh, alg=tb.TileTraversal(tile=32))
    assert sorted(t.contacts_list()) == sorted(tiles.contacts_list())
    via = tb.traverse(tbvh, tb.TileTraversal(tile=32))
    assert via.tile_alg is not None
    assert via.contacts_list() == tiles.contacts_list()
    jt = jtraverse(jbvh, jb.LVTTraversal())
    assert eq(jt.cache1, t.cache1) and eq(jt.cache2, t.cache2)
    again = tb.traverse(tbvh, cache=tb.traverse(
        tbvh, options=tb.BVHOptions(min_capacity=4096)))
    assert again.cache1.shape[0] == 4096
    assert again.contacts_list() == t.contacts_list()


def test_start_level_checks_and_warning():
    xs, rs = spheres(64, 0)
    bvh = tb.build(tb.BSphere(xs, rs, device="cpu"), built_level=2)
    with pytest.raises(ValueError):
        tb.traverse(bvh, start_level=1)
    with pytest.raises(ValueError):
        tb.traverse(bvh, bvh, start_level2=99)
    with pytest.raises(TypeError):
        tb.traverse(bvh, 3)
    with pytest.warns(UserWarning, match="start_level"):
        tb.traverse(bvh, tb.TileTraversal(tile=32), start_level=3)
    with pytest.warns(UserWarning, match="start_level1"):
        tb.traverse(bvh, bvh, tb.TileTraversal(tile=32), start_level1=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = tb.traverse(bvh, start_level=3)
    assert t.start_level == 3
    assert set(t.contacts_list()) == brute_force_self(xs, rs)
    assert tb.traverse(bvh).start_level == 2       # the built level
    one = tb.build(tb.BSphere(xs[:1], rs[:1], device="cpu"))
    empty = tb.traverse(one)
    assert empty.num_contacts == 0 and tuple(empty.cache1.shape) == (0, 2)


@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_ray_walk_matches_jax(kind):
    xs, rs = spheres(200, 5, 6.0)
    rng = np.random.default_rng(6)
    p = (rng.random((3, 77)) * 6.0).astype(np.float32)
    d = (rng.random((3, 77)) - 0.5).astype(np.float32)
    d[0, :8] = 0.0
    jbvh, tbvh = build_both(xs, rs, box=kind == "box")
    jp, jd = jray._prep_rays(p, d, jnp.float32)
    tp, td = tray._prep_rays(p, d, torch.float32, "cpu")
    for sl in (1, 4):
        jc = jray.rays_count(jbvh, jp, jd, sl)
        tc = tray.rays_count(tbvh, tp, td, sl)
        assert eq(jc, tc) and int(tc.sum()) > 0
    jt = jray.traverse_rays(jbvh, p, d, jb.LVTTraversal())
    tt = tb.traverse_rays(tbvh, p, d, tb.LVTTraversal())
    assert tt.num_contacts == int(jt.num_contacts)
    assert eq(jt.cache1, tt.cache1) and eq(jt.cache2, tt.cache2)
    jtot, jout = jray.traverse_rays_fixed(jbvh, p, d, 512, start_level=2)
    ttot, tout = tb.traverse_rays_fixed(tbvh, p, d, 512, start_level=2)
    assert int(jtot) == int(ttot) and eq(jout, tout)
    tiles = tb.traverse_rays(tbvh, p, d)
    assert sorted(tiles.contacts_list()) == sorted(tt.contacts_list())

    def narrow(leaf, pp, dd):
        return leaf.index % 2 == 0

    jn = jray.traverse_rays(jbvh, p, d, jb.LVTTraversal(), narrow=narrow)
    tn = tb.traverse_rays(tbvh, p, d, tb.LVTTraversal(), narrow=narrow,
                          cache=tt)
    assert tn.cache1.shape[0] == tt.cache1.shape[0]
    n = tn.num_contacts
    assert n == int(jn.num_contacts) and eq(jn.cache1[:n], tn.cache1[:n])


def test_dfs_rays_take_the_walk_as_jax():
    """Rays under ``DFSTraversal()`` walk from the caller's start level, as
    ``LVTTraversal()`` does, in both packages (the ray path has no DFS
    default: level 1)."""
    xs, rs = spheres(200, 5, 6.0)
    rng = np.random.default_rng(6)
    p = (rng.random((3, 77)) * 6.0).astype(np.float32)
    d = (rng.random((3, 77)) - 0.5).astype(np.float32)
    jbvh, tbvh = build_both(xs, rs)
    for sl in (None, 3):
        kw = {} if sl is None else {"start_level": sl}
        jt = jray.traverse_rays(jbvh, p, d, jb.DFSTraversal(), **kw)
        tt = tb.traverse_rays(tbvh, p, d, tb.DFSTraversal(), **kw)
        lvt = tb.traverse_rays(tbvh, p, d, tb.LVTTraversal(), **kw)
        assert tt.num_contacts == int(jt.num_contacts) > 0
        assert eq(jt.cache1, tt.cache1) and eq(jt.cache2, tt.cache2)
        assert tt.start_level1 == jt.start_level1 == (sl or 1)
        assert torch.equal(tt.cache1, lvt.cache1)


def test_walk_counts_its_steps_and_syncs():
    """One end test per block of steps; the capacity drops what is past
    it and keeps the total."""
    xs, rs = spheres(80, 11, 2.0)
    bvh = tb.build(tb.BSphere(xs, rs, device="cpu"))
    tracing.reset("walk.")
    tracing.reset("syncs.walk.")
    total, out = tb.traverse_lvt_single_fixed(bvh, 16)
    assert tracing.counter("walk.steps") == \
        tracing.counter("syncs.walk.end") * twalk.BLOCK_STEPS > 0
    full = tb.traverse(bvh)
    assert int(total) == full.num_contacts > 16
    assert torch.equal(out, full.cache1[:16])


@pytest.mark.gpu
def test_walks_on_card_match_cpu():
    """The walks on the card equal the port on the CPU row by row, and the
    default dispatch on the card takes the tile engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    xs1, rs1 = spheres(3000, 1, 14.0)
    xs2, rs2 = spheres(2000, 2, 14.0)
    res = []
    for dev in ("cuda", "cpu"):
        b1 = tb.build(tb.BSphere(xs1, rs1, device=dev), tb.BSphere)
        b2 = tb.build(tb.BSphere(xs2, rs2, device=dev))
        res.append((tb.traverse(b1, tb.LVTTraversal()).cache1.cpu(),
                    tb.traverse(b1, b2, tb.LVTTraversal()).cache1.cpu(),
                    sorted(tb.traverse(b1, b2).contacts_list())))
        if dev == "cuda":
            assert tb.traverse(b1, b2).tile_alg is not None
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1]) and res[0][2] == res[1][2]
