"""The port's depth-first self-contact traversal (``traverse/dfs.py``)
against the JAX package, on the CPU.

The scenes of ``tests/test_dfs.py`` (spheres of one radius, made by numpy
from a seed) go through both packages on the same Morton-sorted BVH (the
JAX package's, carried across as numpy arrays).  Tolerance: exact.  The
count pass's per-lane ``counts``, the write pass's whole ``out`` buffer
(order and the zeros past the total included), the offsets in ``cache2``
and the total must be equal: every lane walks its pair subtree in the same
stack order and writes at scanned offsets, so the order is fixed.  The
sets are also held against a brute force and the LVT walk.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.traverse import dfs as jdfs
    from implicitbvh_tpu.traverse import default_start_level as jax_start
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import tracing
from implicitbvh_tpu_torch.traverse import dfs as tdfs

from test_torch_pair import to_port


@pytest.fixture(autouse=True)
def reference():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def scene(n, seed, r=0.6, node_kind="box"):
    """n spheres of radius r at about unit density, in both packages."""
    rng = np.random.default_rng(seed)
    c = (rng.random((n, 3)) * float(max(n, 2)) ** (1 / 3)).astype(np.float32)
    rs = np.full((n,), np.float32(r))
    jk = jb.BSphere if node_kind == "sphere" else jb.BBox
    jbvh = jb.build(jb.BSphere(jnp.asarray(c), jnp.asarray(rs)), jk)
    return c, rs, jbvh, to_port(jbvh)


def brute(c, rs):
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    hit = d2 <= (rs[:, None] + rs[None, :]) ** 2
    n = len(rs)
    return sorted((i + 1, j + 1) for i in range(n) for j in range(i + 1, n)
                  if hit[i, j])


def same_dfs(jbvh, tbvh, **kw):
    """Both packages' DFS: the count pass's counts, then the whole
    traversal result.  Returns the port's contacts, sorted."""
    sl = kw.get("start_level",
                tb.default_start_level(tbvh, tb.DFSTraversal()))
    if tbvh.tree.real_nodes > 1:
        jc, _ = jdfs.dfs_single_fixed(jbvh, sl, narrow=kw.get("narrow"))
        tc, tout = tdfs.dfs_single_fixed(tbvh, sl, narrow=kw.get("narrow"))
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert tout.shape == (1, 2) and not tout.any()   # the count pass
    j = jb.traverse(jbvh, jb.DFSTraversal(), **kw)
    t = tb.traverse(tbvh, tb.DFSTraversal(), **kw)
    assert np.array_equal(np.asarray(j.cache1), t.cache1.numpy())
    assert np.array_equal(np.asarray(j.cache2), t.cache2.numpy())
    assert int(j.num_contacts) == t.num_contacts
    assert j.start_level1 == t.start_level1
    return sorted(t.contacts_list())


@pytest.mark.parametrize("n", [1, 2, 3, 5, 11, 33, 70, 128, 200])
def test_dfs_matches_jax_and_brute_force(n):
    c, rs, jbvh, tbvh = scene(n, seed=n)
    assert same_dfs(jbvh, tbvh) == brute(c, rs)


def test_dfs_start_level_sweep():
    c, rs, jbvh, tbvh = scene(90, seed=1, r=0.8)
    want = brute(c, rs)
    tracing.reset("dfs.")
    tracing.reset("syncs.dfs.end")
    for sl in range(1, tbvh.tree.levels + 1):
        assert same_dfs(jbvh, tbvh, start_level=sl) == want, sl
    assert tracing.counter("syncs.dfs.end") > 0
    assert tracing.counter("dfs.steps") == \
        tracing.counter("syncs.dfs.end") * tdfs.BLOCK_STEPS


def test_dfs_narrow_matches_jax_and_lvt():
    c, rs, jbvh, tbvh = scene(120, seed=2, r=0.7)

    def narrow(l1, l2):
        return (l1.index + l2.index) % 3 != 0

    got = same_dfs(jbvh, tbvh, narrow=narrow)
    lvt = tb.traverse(tbvh, tb.LVTTraversal(), narrow=narrow)
    assert got == sorted(lvt.contacts_list()) and got


def test_dfs_default_start_level_is_deep():
    """DFS takes BFS's deep default (half the levels): at level 1 the
    initial BVTT is one lane and the whole pair tree is one stack walk."""
    c, rs, jbvh, tbvh = scene(2000, seed=5, r=0.25)
    sl = tb.default_start_level(tbvh, tb.DFSTraversal())
    assert sl == max(tbvh.tree.levels // 2, tbvh.built_level) == \
        jax_start(jbvh, jb.DFSTraversal())
    got = same_dfs(jbvh, tbvh)
    assert got == sorted(tb.traverse(tbvh, tb.LVTTraversal()).contacts_list())


def test_dfs_sphere_leaves_to_sphere_nodes():
    c, rs, jbvh, tbvh = scene(60, seed=3, r=0.9, node_kind="sphere")
    assert same_dfs(jbvh, tbvh) == brute(c, rs)


def test_dfs_cache_reuses_capacity():
    """A repeat with ``cache=`` keeps a capacity that has the room."""
    c, rs, jbvh, tbvh = scene(70, seed=4)
    first = tb.traverse(tbvh, tb.DFSTraversal(),
                        options=tb.BVHOptions(min_capacity=1024))
    again = tb.traverse(tbvh, tb.DFSTraversal(), cache=first)
    assert again.cache1.shape[0] == 1024
    assert torch.equal(again.cache1, first.cache1)
