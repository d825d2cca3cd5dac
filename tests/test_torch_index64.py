"""64-bit user indices (``BVHOptions(index_bits=64)``) in the port against
the JAX package, on the CPU.

Spheres, boxes and rays made by numpy from a seed are built by both
packages with ``index_bits=64`` (``jax_enable_x64`` is on in
``tests/conftest.py``, so the JAX side runs in this process) and go
through every traversal: the tile engine's self and two-tree contact on
both routes, the ray query on both routes, the leaf-vs-tree walks, BFS and
DFS (the JAX package's Pallas kernels in interpret mode, the port's kernels
as their plain PyTorch versions).  Tolerance: exact.  Totals, overflow
bits, ``num_checks`` and the contact rows (as sorted lists where the
packages' emit order differs, else in order) must be equal, and so must the
dtypes of ``contacts``, ``cache1`` and ``cache2``: int64 wherever the JAX
package gives int64.  The empty queries return the JAX package's dtypes at
both index widths.  BVHs carried across with ``interop.bvh_from_numpy``
keep their int64 indices and skips and their 64-bit codes' bit patterns.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.traverse import ray_tiles as jray
    from implicitbvh_tpu.traverse import tiles as jtiles
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb

from test_torch_pair import brute_force_pair, spheres, to_port
from test_torch_rays import random_rays, random_scene

I64 = dict(index_bits=64)
TWO_PHASE = dict(tile=32, row_cap=16, pair_cap=128, count_w=2, emit_w=2)
FALLBACK = dict(tile=32, row_cap=16, pair_cap=256, count_w=2)
ROUTES = {"two_phase": (TWO_PHASE, 1024), "fallback": (FALLBACK, 1000)}


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def torch_dtype(a):
    return getattr(torch, np.asarray(a).dtype.name)


def same_array(a, t):
    """A JAX array and a torch tensor agree in dtype, shape and values."""
    assert t.dtype == torch_dtype(a), (t.dtype, np.asarray(a).dtype)
    assert np.array_equal(np.asarray(a), t.numpy())


def volumes(xs, rs, box):
    if box:
        lo, up = xs - rs[:, None], xs + rs[:, None]
        return (jb.BBox(jnp.asarray(lo), jnp.asarray(up)),
                tb.BBox(torch.from_numpy(lo), torch.from_numpy(up)))
    return (jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)),
            tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))


def build64(xs, rs, box=False, **opts):
    """(JAX BVH, port BVH) over the same leaves with ``index_bits=64``."""
    jv, tv = volumes(xs, rs, box)
    return (jb.build(jv, jb.BBox, options=jb.BVHOptions(**I64, **opts)),
            tb.build(tv, options=tb.BVHOptions(**I64, **opts)))


def same_fixed(jout, tout, ordered):
    """Two ``*_fixed`` results: the total, overflow and ``num_checks``,
    the contact rows (in order, or sorted) and their dtype.  (The JAX
    package's scalar outputs take int64 from Python literals under x64 at
    either index width; their values are compared.)"""
    assert tout[1].dtype == torch_dtype(jout[1])
    jt, jc, jo, jn = (np.asarray(x) for x in jout)
    tt, tc, to, tn = (x.numpy() for x in tout)
    assert (int(jt), int(jo), float(jn)) == (int(tt), int(to), float(tn))
    n = min(int(tt), tc.shape[0])
    rows_j, rows_t = jc[:n].tolist(), tc[:n].tolist()
    if not ordered:
        rows_j, rows_t = sorted(rows_j), sorted(rows_t)
    assert rows_j == rows_t and not tc[n:].any()
    return {tuple(r) for r in rows_t}


def same_traversal(j, t):
    """Two ``BVHTraversal`` results: ``cache1``/``cache2`` in dtype, shape
    and values, ``num_contacts`` (a Python int in the port)."""
    same_array(j.cache1, t.cache1)
    same_array(j.cache2, t.cache2)
    assert isinstance(t.num_contacts, int)
    assert int(j.num_contacts) == t.num_contacts
    return set(t.contacts_list())


def brute_force_self(xs, rs):
    return {(i, j) for i, j in brute_force_pair(xs, rs, xs, rs) if i < j}


@pytest.fixture(scope="module")
def self_scene():
    xs, rs = spheres(150, 41)
    return xs, rs, *build64(xs, rs)


def test_build_int64_matches_jax(self_scene):
    _, _, jbvh, tbvh = self_scene
    assert tbvh.leaves.index.dtype == tbvh.skips.dtype == torch.int64
    same_array(jbvh.leaves.index, tbvh.leaves.index)
    same_array(jbvh.skips, tbvh.skips)
    assert np.array_equal(np.asarray(jbvh.leaves.morton).astype(np.int64),
                          tbvh.leaves.morton.numpy())
    for a, b in zip(jbvh.nodes.los + jbvh.nodes.ups,
                    tbvh.nodes.los + tbvh.nodes.ups):
        same_array(a, b)
    custom = np.arange(3 << 31, (3 << 31) + 150, dtype=np.int64)
    _, tv = volumes(*self_scene[:2], False)
    leaves = tb.wrap_bounding_volumes(tv, tb.BVHOptions(**I64), custom)
    assert leaves.index.dtype == torch.int64
    got = tb.build(leaves, options=tb.BVHOptions(**I64))
    assert sorted(got.leaves.index.tolist()) == custom.tolist()


@pytest.mark.parametrize("bits", [32, 64])
def test_interop_keeps_int64_indices_and_code_bits(bits):
    """A JAX BVH built with 64-bit indices (and, at 64 bits, extended
    codes, some with bit 63 set) carried across equals the port's own
    build: no index, skip or code is narrowed."""
    xs, rs = spheres(150, 41)
    alg = dict(morton=jb.ExtendedMortonAlgorithm(bits=bits))
    jv, tv = volumes(xs, rs, False)
    jbvh = jb.build(jv, jb.BBox, options=jb.BVHOptions(**I64, **alg))
    tbvh = tb.build(tv, options=tb.BVHOptions(
        **I64, morton=tb.ExtendedMortonAlgorithm(bits=bits)))
    got = to_port(jbvh)
    for a, b in ((got.leaves.index, tbvh.leaves.index),
                 (got.skips, tbvh.skips),
                 (got.leaves.morton, tbvh.leaves.morton)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.skips.dtype == got.leaves.index.dtype == torch.int64
    if bits == 64:
        assert 0 < int((got.leaves.morton < 0).sum()) < 150


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tile_self_int64_matches_jax(self_scene, route):
    xs, rs, jbvh, tbvh = self_scene
    params, capacity = ROUTES[route]
    jout = jb.traverse_tiles_fixed(jbvh, capacity,
                                   alg=jb.TileTraversal(**params))
    tout = tb.traverse_tiles_fixed(tbvh, capacity,
                                   alg=tb.TileTraversal(**params))
    assert tout[1].dtype == torch.int64
    got = same_fixed(jout, tout, ordered=False)
    assert got == brute_force_self(xs, rs) and int(tout[2]) == 0


def test_tile_self_wrapper_int64_matches_jax(self_scene):
    """``traverse_tiles`` grows from the default capacities and returns
    the JAX package's buffers and dtypes; a cached call agrees too."""
    _, _, jbvh, tbvh = self_scene
    alg = dict(tile=32, count_w=2, emit_w=2)
    j = jb.traverse(jbvh, jb.TileTraversal(**alg))
    t = tb.traverse(tbvh, tb.TileTraversal(**alg))
    assert sorted(map(tuple, np.asarray(j.contacts).tolist())) == \
        sorted(t.contacts_list())
    assert t.cache2.dtype == torch_dtype(j.cache2) == torch.int64
    assert t.cache1.dtype == torch_dtype(j.cache1) == torch.int64
    assert t.cache1.shape == np.asarray(j.cache1).shape
    again = tb.traverse(tbvh, tb.TileTraversal(**alg), cache=t)
    assert again.cache1.dtype == torch.int64
    assert sorted(again.contacts_list()) == sorted(t.contacts_list())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tile_pair_int64_matches_jax(route):
    xs1, rs1 = spheres(150, 41)
    xs2, rs2 = spheres(90, 42)
    j1, t1 = build64(xs1, rs1)
    j2, t2 = build64(xs2, rs2)
    params, capacity = ROUTES[route]
    jout = jtiles.traverse_tiles_pair_fixed(j1, j2, capacity,
                                            alg=jb.TileTraversal(**params))
    tout = tb.traverse_tiles_pair_fixed(t1, t2, capacity,
                                        alg=tb.TileTraversal(**params))
    got = same_fixed(jout, tout, ordered=route == "fallback")
    assert got == brute_force_pair(xs1, rs1, xs2, rs2)
    assert tout[1].dtype == torch.int64 and int(tout[2]) == 0


@pytest.fixture(scope="module")
def ray_scene():
    xs, rs = random_scene(300, 0)
    p, d = random_rays(77, 1, scale=float(300) ** (1 / 3) * 1.5)
    return xs, rs, p, d, *build64(xs, rs)


RAY_ROUTES = {"two_phase": dict(tile=32, row_cap=8, emit_w=8, decode_k=8),
              "fallback": dict(tile=32, row_cap=8, pair_cap=256)}


@pytest.mark.parametrize("route", sorted(RAY_ROUTES))
def test_rays_int64_match_jax(ray_scene, route):
    """The ray query: its ``iray_map`` is int32 in both packages and meets
    the int64 leaf indices in ``_finish_contacts``."""
    *_, p, d, jbvh, tbvh = ray_scene
    alg = RAY_ROUTES[route]
    capacity = 1024 if route == "two_phase" else 1000
    jout = jray.traverse_rays_tiles_fixed(jbvh, p, d, capacity=capacity,
                                          alg=jb.TileTraversal(**alg))
    tout = tb.traverse_rays_tiles_fixed(tbvh, p, d, capacity=capacity,
                                        alg=tb.TileTraversal(**alg))
    got = same_fixed(jout, tout, ordered=False)
    assert tout[1].dtype == torch.int64 and int(tout[2]) == 0 and got


def test_ray_wrappers_int64_match_jax(ray_scene):
    """``traverse_rays`` through the tile wrapper, the walk and BFS."""
    *_, p, d, jbvh, tbvh = ray_scene
    j = jray.traverse_rays_tiles(jbvh, p, d)
    t = tb.traverse_rays_tiles(tbvh, p, d)
    tile = set(t.contacts_list())
    assert tile == {tuple(r) for r in np.asarray(j.contacts).tolist()}
    assert t.cache1.dtype == torch_dtype(j.cache1) == torch.int64
    assert t.cache2.dtype == torch_dtype(j.cache2) == torch.int64
    for alg in ("LVTTraversal", "BFSTraversal"):
        got = same_traversal(
            jb.traverse_rays(jbvh, p, d, getattr(jb, alg)()),
            tb.traverse_rays(tbvh, p, d, getattr(tb, alg)()))
        assert got == tile


def test_walks_int64_match_jax(self_scene):
    """The leaf-vs-tree walks, self and two trees, buffer for buffer."""
    xs, rs, jbvh, tbvh = self_scene
    got = same_traversal(jb.traverse(jbvh, jb.LVTTraversal()),
                         tb.traverse(tbvh, tb.LVTTraversal()))
    assert got == brute_force_self(xs, rs)
    xs2, rs2 = spheres(90, 42)
    j2, t2 = build64(xs2, rs2)
    got = same_traversal(jb.traverse(jbvh, j2, jb.LVTTraversal()),
                         tb.traverse(tbvh, t2, tb.LVTTraversal()))
    assert got == brute_force_pair(xs, rs, xs2, rs2)


def test_bfs_int64_matches_jax(self_scene):
    xs, rs, jbvh, tbvh = self_scene
    got = same_traversal(jb.traverse(jbvh, jb.BFSTraversal()),
                         tb.traverse(tbvh, tb.BFSTraversal()))
    assert got == brute_force_self(xs, rs)
    xs2, rs2 = spheres(90, 42)
    j2, t2 = build64(xs2, rs2)
    got = same_traversal(jb.traverse(jbvh, j2, jb.BFSTraversal()),
                         tb.traverse(tbvh, t2, tb.BFSTraversal()))
    assert got == brute_force_pair(xs, rs, xs2, rs2)


def test_dfs_int64_matches_jax(self_scene):
    xs, rs, jbvh, tbvh = self_scene
    got = same_traversal(jb.traverse(jbvh, jb.DFSTraversal()),
                         tb.traverse(tbvh, tb.DFSTraversal()))
    assert got == brute_force_self(xs, rs)


@pytest.mark.parametrize("bits", [32, 64])
def test_empty_queries_match_jax_dtypes(bits):
    """A one-leaf self query, a query with no rays and a query on a
    one-leaf tree return empty buffers of the JAX package's dtypes."""
    xs = np.zeros((1, 3), np.float32)
    rs = np.ones(1, np.float32)
    jbvh, tbvh = build64(xs, rs) if bits == 64 else (
        jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox),
        tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))))
    p0 = np.zeros((3, 0), np.float32)
    cases = [(jtiles.traverse_tiles(jbvh), tb.traverse_tiles(tbvh)),
             (jb.traverse(jbvh, jb.LVTTraversal()),
              tb.traverse(tbvh, tb.LVTTraversal())),
             (jray.traverse_rays_tiles(jbvh, p0, p0),
              tb.traverse_rays_tiles(tbvh, p0, p0)),
             (jb.traverse_rays(jbvh, p0, p0, jb.LVTTraversal()),
              tb.traverse_rays(tbvh, p0, p0, tb.LVTTraversal()))]
    for j, t in cases:
        assert same_traversal(j, t) == set()


@pytest.mark.gpu
def test_int64_tile_self_and_rays_on_card_match_cpu():
    """With ``index_bits=64``, tile self-contact (both routes) and the ray
    query (both routes) on the card (CUDA kernels) equal the port on the
    CPU (plain versions), with int64 contacts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(43)
    n, nrays = 5000, 3000
    xs = (rng.random((n, 3)) * 17).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    p = (rng.random((3, nrays)) * 17).astype(np.float32)
    d = (rng.random((3, nrays)) - 0.5).astype(np.float32)
    opts = tb.BVHOptions(index_bits=64)
    bvhs = {dev: tb.build(tb.BSphere(xs, rs, device=dev), options=opts)
            for dev in ("cuda", "cpu")}
    runs = [lambda b, a: tb.traverse_tiles_fixed(b, 1 << 14, alg=a),
            lambda b, a: tb.traverse_rays_tiles_fixed(b, p, d, 1 << 15,
                                                      alg=a)]
    algs = [tb.TileTraversal(row_cap=8, pair_cap=64, emit_w=8, decode_k=8),
            tb.TileTraversal(row_cap=32, pair_cap=512)]
    for run in runs:
        for alg in algs:
            res = []
            for dev, bvh in bvhs.items():
                t, c, o, nc = run(bvh, alg)
                assert c.dtype == torch.int64
                rows = sorted(map(tuple, c[:int(t)].cpu().tolist()))
                res.append((rows, int(t), int(o), float(nc)))
            assert res[0] == res[1] and res[0][2] == 0 and res[0][1] > 0
