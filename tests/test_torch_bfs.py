"""The port's breadth-first traversal (``traverse/bfs.py``) and the helpers
it needs (``utils``: the child helpers, ``_block_search``, ``k2ij_*``)
against the JAX package, on the CPU.

The scenes of ``tests/test_bfs.py`` (spheres made by numpy from a seed) go
through ``traverse`` of both packages on the same Morton-sorted BVH (the
JAX package's, carried across as numpy arrays).  Tolerance: exact.  The
whole ``cache1`` buffer must be equal, order and the zeros past the total
included, and so must ``num_contacts`` and ``num_checks``: the frontier is
compacted deterministically, slot-major per source pair, so its order is
fixed.  Each ``bfs_*_fixed`` is also called at one capacity too small for
its scene, so the overflow flag and the truncated buffer are compared.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import utils as jutils
    from implicitbvh_tpu.raytrace import traverse_rays as jax_traverse_rays
    from implicitbvh_tpu.traverse import bfs as jbfs
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import tracing
from implicitbvh_tpu_torch import utils as tutils
from implicitbvh_tpu_torch.traverse import bfs as tbfs

from test_torch_pair import brute_force_pair, spheres, to_port


@pytest.fixture(autouse=True)
def reference():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def both(xs, rs, node_kind="box"):
    """(JAX BVH, the same BVH in the port)."""
    jk = jb.BSphere if node_kind == "sphere" else jb.BBox
    jbvh = jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jk)
    return jbvh, to_port(jbvh)


def same_result(j, t):
    """The JAX package's and the port's traversal results are equal:
    the whole contact buffer in order, the total and ``num_checks``."""
    assert np.array_equal(np.asarray(j.cache1), t.cache1.numpy())
    assert int(j.num_contacts) == t.num_contacts
    assert int(j.num_checks) == t.num_checks
    assert (j.start_level1, j.start_level2) == (t.start_level1,
                                                t.start_level2)
    return {tuple(r) for r in t.contacts.tolist()}


def same_fixed(j, t):
    """Equal ``(total, contacts, num_checks, overflow)`` of two
    ``*_fixed`` calls."""
    for a, b in zip(j, t, strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())
    return bool(t[3])


def brute_force_self(xs, rs):
    return {(i, j) for i, j in brute_force_pair(xs, rs, xs, rs) if i < j}


def test_bfs_readme_demo():
    xs = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4]],
                  np.float32)
    rs = np.array([0.5, 0.6, 0.5, 0.4, 0.6], np.float32)
    jbvh, tbvh = both(xs, rs)
    t = tb.traverse(tbvh, tb.BFSTraversal())
    same_result(jb.traverse(jbvh, jb.BFSTraversal()), t)
    assert sorted(t.contacts_list()) == [(1, 2), (2, 3), (4, 5)]
    assert t.num_checks > 0 and t.cache2.shape == (0,)


@pytest.mark.parametrize("sl", [1, 4, "levels"])
def test_bfs_differential(sl):
    xs, rs = spheres(166, 42)
    jbvh, tbvh = both(xs, rs)
    sl = jbvh.tree.levels if sl == "levels" else sl
    got = same_result(jb.traverse(jbvh, jb.BFSTraversal(), start_level=sl),
                      tb.traverse(tbvh, tb.BFSTraversal(), start_level=sl))
    assert got == brute_force_self(xs, rs)


def test_bfs_sphere_nodes():
    xs, rs = spheres(100, 3)
    jbvh, tbvh = both(xs, rs, node_kind="sphere")
    got = same_result(jb.traverse(jbvh, jb.BFSTraversal()),
                      tb.traverse(tbvh, tb.BFSTraversal()))
    assert got == brute_force_self(xs, rs)


def test_bfs_narrow_matches_jax_and_lvt():
    xs, rs = spheres(150, 8)
    jbvh, tbvh = both(xs, rs)

    def narrow(l1, l2):
        return (l1.index * 7 + l2.index * 3) % 5 != 0

    got = same_result(jb.traverse(jbvh, jb.BFSTraversal(), narrow=narrow),
                      tb.traverse(tbvh, tb.BFSTraversal(), narrow=narrow))
    lvt = tb.traverse(tbvh, tb.LVTTraversal(), narrow=narrow)
    assert got == set(lvt.contacts_list()) and len(got) > 0


@pytest.mark.parametrize("n2", [45, 20])
def test_bfs_pair_both_orders(n2):
    """Both orders: 60 against 45 leaves (equal heights: phases A and F),
    and 60 against 20 (unequal heights: phases B and C)."""
    xs1, rs1 = spheres(60, 0)
    xs2, rs2 = spheres(n2, 1)
    (j1, t1), (j2, t2) = both(xs1, rs1), both(xs2, rs2)
    assert (j1.tree.levels != j2.tree.levels) == (n2 == 20)
    bf = brute_force_pair(xs1, rs1, xs2, rs2)
    got = same_result(jb.traverse(j1, j2, jb.BFSTraversal()),
                      tb.traverse(t1, t2, tb.BFSTraversal()))
    assert got == bf
    got = same_result(jb.traverse(j2, j1, jb.BFSTraversal()),
                      tb.traverse(t2, t1, tb.BFSTraversal()))
    assert got == {(j, i) for i, j in bf}


def test_bfs_pair_leaf_level_tree():
    """bvh2 is a single leaf: phase D (node against leaf), and flipped,
    phase E."""
    xs1, rs1 = spheres(33, 5)
    xs2 = np.array([[2.5, 2.5, 2.5]], np.float32)
    rs2 = np.array([1.0], np.float32)
    (j1, t1), (j2, t2) = both(xs1, rs1), both(xs2, rs2)
    bf = brute_force_pair(xs1, rs1, xs2, rs2)
    got = same_result(jb.traverse(j1, j2, jb.BFSTraversal()),
                      tb.traverse(t1, t2, tb.BFSTraversal()))
    assert got == bf and len(bf) > 0
    got = same_result(jb.traverse(j2, j1, jb.BFSTraversal()),
                      tb.traverse(t2, t1, tb.BFSTraversal()))
    assert got == {(j, i) for i, j in bf}


def test_bfs_rays_match_jax_and_lvt():
    rng = np.random.default_rng(9)
    xs, rs = spheres(64, 10)
    p = rng.random((3, 20)).astype(np.float32) * 8 - 1.5
    d = rng.random((3, 20)).astype(np.float32) - 0.5
    jbvh, tbvh = both(xs, rs)
    tp, td = torch.from_numpy(p), torch.from_numpy(d)
    got = same_result(jax_traverse_rays(jbvh, p, d, jb.BFSTraversal()),
                      tb.traverse_rays(tbvh, tp, td, tb.BFSTraversal()))
    lvt = tb.traverse_rays(tbvh, tp, td, tb.LVTTraversal())
    assert got == set(lvt.contacts_list()) and len(got) > 0


def test_bfs_overflow_growth_and_cache():
    """A tiny ``min_capacity`` makes the growth loop run again with larger
    buffers; a repeat with ``cache=`` starts from the grown capacity."""
    xs, rs = spheres(120, 12, scale=2.0)      # dense: many contacts
    opts_j, opts_t = jb.BVHOptions(min_capacity=8), \
        tb.BVHOptions(min_capacity=8)
    jbvh = jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox,
                    options=opts_j)
    tbvh = to_port(jbvh)
    tracing.reset("bfs.runs")
    j = jb.traverse(jbvh, jb.BFSTraversal(), options=opts_j)
    t = tb.traverse(tbvh, tb.BFSTraversal(), options=opts_t)
    assert same_result(j, t) == brute_force_self(xs, rs)
    assert tracing.counter("bfs.runs") > 1
    again = tb.traverse(tbvh, tb.BFSTraversal(), options=opts_t, cache=t)
    assert torch.equal(again.cache1, t.cache1)


@pytest.mark.parametrize("kind", ["single", "pair", "rays"])
def test_bfs_fixed_overflow_matches_jax(kind):
    """Each ``bfs_*_fixed`` at one capacity, too small for the scene: the
    same overflow flag and the same truncated buffer; and at a capacity
    that holds it, no overflow."""
    xs, rs = spheres(90, 21)
    jbvh, tbvh = both(xs, rs)
    xs2, rs2 = spheres(70, 22)
    jbvh2, tbvh2 = both(xs2, rs2)
    rng = np.random.default_rng(23)
    p = rng.random((3, 30)).astype(np.float32) * 6 - 0.5
    d = rng.random((3, 30)).astype(np.float32) - 0.5
    jp, jd = tuple(jnp.asarray(c) for c in p), tuple(jnp.asarray(c)
                                                       for c in d)
    tp, td = tuple(torch.from_numpy(c) for c in p), \
        tuple(torch.from_numpy(c) for c in d)
    calls = {
        "single": (lambda c: jbfs.bfs_single_fixed(jbvh, 3, c),
                   lambda c: tbfs.bfs_single_fixed(tbvh, 3, c)),
        "pair": (lambda c: jbfs.bfs_pair_fixed(jbvh, jbvh2, 2, 3, c),
                 lambda c: tbfs.bfs_pair_fixed(tbvh, tbvh2, 2, 3, c)),
        "rays": (lambda c: jbfs.bfs_rays_fixed(jbvh, jp, jd, 2, c),
                 lambda c: tbfs.bfs_rays_fixed(tbvh, tp, td, 2, c)),
    }
    jf, tf = calls[kind]
    assert same_fixed(jf(64), tf(64))
    assert not same_fixed(jf(2048), tf(2048))


# --------------------------------------------------------------------------
# utils: child helpers and upper-triangle unranking
# --------------------------------------------------------------------------

def test_child_helpers_match_jax():
    i1 = np.array([1, 2, 5, 9, 100], np.int32)
    i2 = np.array([1, 3, 7, 12, 255], np.int32)
    for name in ("leftleft", "leftright", "rightleft", "rightright",
                 "leftnoop", "rightnoop", "noopleft", "noopright"):
        want = getattr(jutils, name)(jnp.asarray(i1), jnp.asarray(i2))
        got = getattr(tutils, name)(torch.from_numpy(i1),
                                    torch.from_numpy(i2))
        for w, g in zip(want, got, strict=True):
            assert np.array_equal(np.asarray(w), g.numpy()), name


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 513])
def test_k2ij_matches_jax(n):
    """Every k of both orders, and ``_block_search`` on its own."""
    for name, size in (("k2ij_inclusive", n * (n + 1) // 2),
                       ("k2ij_exclusive", n * (n - 1) // 2)):
        k = np.arange(size, dtype=np.int32)
        want = getattr(jutils, name)(n, jnp.asarray(k))
        got = getattr(tutils, name)(n, torch.from_numpy(k))
        for w, g in zip(want, got, strict=True):
            assert np.array_equal(np.asarray(w), g.numpy()), name
            assert g.dtype == torch.int32
    k = np.arange(0, 3 * n + 1, dtype=np.int32)
    want = jutils._block_search(lambda t: t * 3, n, jnp.asarray(k))
    got = tutils._block_search(lambda t: t * 3, n, torch.from_numpy(k))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_k2ij_past_int32_products():
    """At n = 50,000 the unranking's products (about n^2) pass 2^31 while
    every k still fits int32: the port computes in int64 and equals a loop
    over the rows (the JAX package's int32 arithmetic wraps here)."""
    n = 50_000
    rng = np.random.default_rng(0)
    for name, off in (("k2ij_exclusive", 1), ("k2ij_inclusive", 0)):
        size = n * (n - 1) // 2 if off else n * (n + 1) // 2
        assert size < 2 ** 31 < n * n
        k = np.unique(np.concatenate([np.arange(0, 50),
                                      size - 1 - np.arange(50),
                                      rng.integers(0, size, 400)]))
        want_i, want_j = [], []
        i, start = 0, 0                 # row i's block starts at k = start
        for kk in k.tolist():
            while start + (n - i - off) <= kk:
                start += n - i - off
                i += 1
            want_i.append(i)
            want_j.append(i + off + kk - start)
        gi, gj = getattr(tutils, name)(n, torch.from_numpy(
            k.astype(np.int32)))
        assert gi.tolist() == want_i and gj.tolist() == want_j, name
