"""The pair-granularity fallback of tile self-contact against the JAX
package, on the CPU.

``traverse_tiles_fixed`` takes the fallback when ``pair_cap > 128`` or the
capacity is not a multiple of 1024, and ``traverse_tiles`` grows into it
from small capacities and slot caps.  Triangles or spheres made by numpy
from a seed go through both packages (the JAX package's Pallas kernels in
interpret mode, the port's kernels as their plain PyTorch versions); the
sorted contacts, the total, the overflow bits and ``num_checks`` must agree
exactly, and the contacts must equal a brute-force sphere test.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import interop

CPU = torch.device("cpu")


def triangles(n, seed):
    rng = np.random.default_rng(seed)
    scale = float(n) ** (1.0 / 3.0)
    c = (rng.random((n, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n, 3)) - 0.5).astype(np.float32) * 0.4
    return [c, c + e1, c + e2]


def spheres(n, seed, scale):
    rng = np.random.default_rng(seed)
    xs = (rng.random((n, 3)) * scale).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    return xs, rs


def brute_force(xs, rs):
    """1-based (i, j), i < j, of every sphere pair in contact, evaluated in
    float32 in the kernels' operation order."""
    d = [xs[:, None, k] - xs[None, :, k] for k in range(3)]
    rr = rs[:, None] + rs[None, :]
    hit = np.triu(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr, 1)
    return {(int(i) + 1, int(j) + 1) for i, j in zip(*np.nonzero(hit))}


def pairs(contacts, total):
    return sorted(map(tuple, np.asarray(contacts)[:int(total)].tolist()))


def summary(out):
    t, c, o, nc = out
    return pairs(c, t), int(t), int(o), float(nc)


def needs_jax():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


SLICES = {  # (triangles, seed, traversal parameters, capacity)
    "2048_pair_cap256": (2048, 0, dict(tile=32, count_w=2, row_cap=16,
                                       pair_cap=256), 4096),
    "500_capacity512": (500, 4, dict(tile=32, count_w=2), 512),
}


@pytest.fixture(scope="module", params=sorted(SLICES))
def slice_run(request):
    """JAX and port results of one slice, the port's spheres and the JAX
    BVH."""
    needs_jax()
    n, seed, params, capacity = SLICES[request.param]
    tri = triangles(n, seed)
    js = jb.bsphere_from_triangles(*[jnp.asarray(p) for p in tri])
    jbvh = jb.build(js, jb.BBox)
    want = summary(jb.traverse_tiles_fixed(jbvh, capacity,
                                           alg=jb.TileTraversal(**params)))
    ts = tb.bsphere_from_triangles(*[torch.from_numpy(p) for p in tri])
    got = summary(tb.traverse_tiles_fixed(tb.build(ts), capacity,
                                          alg=tb.TileTraversal(**params)))
    return params, capacity, want, got, ts, jbvh


def test_fallback_matches_jax_and_brute_force(slice_run):
    _, _, want, got, ts, _ = slice_run
    assert got == want
    total, overflow = got[1], got[2]
    assert overflow == 0 and total > 0
    bf = brute_force(np.stack([x.numpy() for x in ts.xs], 1), ts.r.numpy())
    assert set(got[0]) == bf and len(got[0]) == total


def test_fallback_on_the_jax_bvh(slice_run):
    """The JAX package's BVH carried across gives the same result."""
    params, capacity, want, _, _, jbvh = slice_run
    d = {"leaf_kind": "sphere", "index": np.asarray(jbvh.leaves.index),
         "morton": np.asarray(jbvh.leaves.morton),
         "skips": np.asarray(jbvh.skips), "built_level": jbvh.built_level,
         "num_leaves": jbvh.num_leaves,
         "leaf_r": np.asarray(jbvh.leaves.volume.r)}
    for k in range(3):
        d[f"leaf_x{k}"] = np.asarray(jbvh.leaves.volume.xs[k])
        d[f"node_lo{k}"] = np.asarray(jbvh.nodes.los[k])
        d[f"node_up{k}"] = np.asarray(jbvh.nodes.ups[k])
    out = tb.traverse_tiles_fixed(interop.bvh_from_numpy(d, CPU), capacity,
                                  alg=tb.TileTraversal(**params))
    assert summary(out) == want


def test_fallback_narrow_matches_jax():
    needs_jax()

    def narrow(l1, l2):
        return (l1.index + l2.index) % 3 != 0

    tri = triangles(1024, 3)
    params = dict(tile=32, count_w=2, row_cap=16, pair_cap=256)
    js = jb.bsphere_from_triangles(*[jnp.asarray(p) for p in tri])
    want = summary(jb.traverse_tiles_fixed(
        jb.build(js, jb.BBox), 2048, alg=jb.TileTraversal(**params),
        narrow=narrow))
    ts = tb.bsphere_from_triangles(*[torch.from_numpy(p) for p in tri])
    got = summary(tb.traverse_tiles_fixed(
        tb.build(ts), 2048, alg=tb.TileTraversal(**params), narrow=narrow))
    assert got == want and got[2] == 0
    bf = brute_force(np.stack([x.numpy() for x in ts.xs], 1), ts.r.numpy())
    assert set(got[0]) == {(i, j) for i, j in bf if (i + j) % 3}


def test_growth_into_the_fallback_matches_jax():
    """The dense cluster of the JAX package's growth test, from row_cap 2 /
    pair_cap 4 with default options (capacity 128): both packages grow
    into the fallback and end with the same contacts and capacities."""
    needs_jax()
    xs, rs = spheres(96, 5, 0.8)
    params = dict(tile=32, row_cap=2, pair_cap=4)
    jt = jb.traverse_tiles(
        jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox),
        alg=jb.TileTraversal(**params))
    tt = tb.traverse_tiles(
        tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))),
        alg=tb.TileTraversal(**params))
    assert sorted(tt.contacts_list()) == sorted(jt.contacts_list())
    assert set(tt.contacts_list()) == brute_force(xs, rs)
    assert (tt.tile_alg.row_cap, tt.tile_alg.pair_cap) == \
        (jt.tile_alg.row_cap, jt.tile_alg.pair_cap)
    assert tt.tile_alg.pair_cap > 128          # grown past the two-phase
    assert tt.pair_capacity == jt.pair_capacity
    assert tuple(tt.cache1.shape) == tuple(jt.cache1.shape)
    assert tt.num_checks == jt.num_checks


ROUTE_KERNELS = ("compact_flat", "tile_group_contacts", "tile_run_counts",
                 "tile_group_emit")


def called_kernels(monkeypatch, fn, *args, **kw):
    """``fn(*args, **kw)`` and the kernel wrappers of either route that it
    called (on the CPU the wrappers count no launches)."""
    from implicitbvh_tpu_torch.traverse import tiles as ttiles
    called = set()
    with monkeypatch.context() as mp:
        for k in ROUTE_KERNELS:
            def rec(*a, _k=k, _fn=getattr(ttiles, k), **k2):
                called.add(_k)
                return _fn(*a, **k2)
            mp.setattr(ttiles, k, rec)
        return fn(*args, **kw), called


@pytest.mark.parametrize("bands", (4, 8))
def test_fallback_equals_two_phase(monkeypatch, bands):
    """The same BVH through both routes (pair_cap 32 and 256) gives the
    same contact set; at 4 bands both count the same leaf tests."""
    tri = triangles(2048, 0)
    bvh = tb.build(tb.bsphere_from_triangles(*tri, device="cpu"))
    res = {}
    for pair_cap in (32, 256):
        out, called = called_kernels(
            monkeypatch, tb.traverse_tiles_fixed, bvh, 4096,
            alg=tb.TileTraversal(tile=32, count_w=2, row_cap=16,
                                 pair_cap=pair_cap, bands=bands))
        res[pair_cap] = summary(out)
        assert called == ({"compact_flat", "tile_group_contacts"}
                          if pair_cap > 128 else
                          {"tile_run_counts", "tile_group_emit"})
    (c1, t1, o1, n1), (c2, t2, o2, n2) = res[32], res[256]
    assert c1 == c2 and t1 == t2 and o1 == o2 == 0 and t1 > 0
    if bands == 4:
        assert n1 == n2
    else:                      # 8 fine bands test fewer rows than 4 folded
        assert n1 <= n2


def test_readme_demo_default_options_takes_the_fallback(monkeypatch):
    """Five spheres with default options: capacity 64, so the fallback."""
    xs = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4]],
                  np.float32)
    rs = np.array([0.5, 0.6, 0.5, 0.4, 0.6], np.float32)
    t, called = called_kernels(
        monkeypatch, tb.traverse_tiles,
        tb.build(tb.BSphere(xs, rs, device="cpu")))
    assert t.contacts_list() == [(1, 2), (2, 3), (4, 5)]
    assert t.cache1.shape[0] == 64
    assert called == {"compact_flat", "tile_group_contacts"}


def test_growth_end_raises_naming_a11(monkeypatch):
    """Eight runs that all overflow used to raise ``NotImplementedError``
    naming ROADMAP A11; they now end in the leaf-vs-tree walk, which
    returns the brute force's set with no tile parameters."""
    from implicitbvh_tpu_torch.traverse import tiles as ttiles
    xs, rs = spheres(96, 5, 0.8)
    bvh = tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs)))
    fixed = ttiles.traverse_tiles_fixed
    calls = []

    def always_over(*args, **kw):
        calls.append(kw["alg"])
        total, contacts, _, num_checks = fixed(*args, **kw)
        return total, contacts, torch.tensor(2, dtype=torch.int32), \
            num_checks

    monkeypatch.setattr(ttiles, "traverse_tiles_fixed", always_over)
    t = ttiles.traverse_tiles(bvh, alg=tb.TileTraversal(tile=32))
    assert len(calls) == 8 and calls[-1].pair_cap == ttiles.MAX_PAIR_CAP
    assert t.tile_alg is None and t.cache2.shape[0] == 96
    assert set(t.contacts_list()) == brute_force(xs, rs)
    assert len(t.contacts_list()) == t.num_contacts


@pytest.mark.gpu
@pytest.mark.parametrize("n, params, capacity", [
    (5000, dict(row_cap=32, pair_cap=512), 4096),
    (500, dict(tile=32), 512),
])
def test_fallback_on_card_matches_cpu(n, params, capacity):
    """The fallback on the card (CUDA kernels) equals the port on the CPU
    (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tri = triangles(n, 1)
    res = []
    for dev in ("cuda", "cpu"):
        s = tb.bsphere_from_triangles(*tri, device=dev)
        out = tb.traverse_tiles_fixed(tb.build(s), capacity,
                                      alg=tb.TileTraversal(**params))
        res.append(summary(tuple(x.cpu() for x in out)))
    assert res[0] == res[1] and res[0][2] == 0
