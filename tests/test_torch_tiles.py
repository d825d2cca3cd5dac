"""The port's slice as a whole against the JAX package, on the CPU.

Triangles made by numpy from a seed go through ``bsphere_from_triangles``,
``build`` and ``traverse_tiles_fixed`` of both packages (the JAX package's
Pallas kernels in interpret mode, the port's kernels as their plain PyTorch
versions).  The sorted contacts, the total, the overflow bits and
``num_checks`` must agree exactly, and the contacts must equal a brute-force
sphere test: every predicate is a comparison of identically rounded float32
values and every count is an integer.
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
    out = set()
    for i0 in range(0, len(rs), 512):
        d = [xs[i0:i0 + 512, None, k] - xs[None, :, k] for k in range(3)]
        rr = rs[i0:i0 + 512, None] + rs[None, :]
        hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
        for i, jj in zip(*np.nonzero(hit)):
            if i0 + i < jj:
                out.add((int(i0 + i) + 1, int(jj) + 1))
    return out


def pairs(contacts, total):
    return sorted(map(tuple, np.asarray(contacts)[:int(total)].tolist()))


def needs_jax():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def run_both(tri, capacity, params, narrow=None):
    """(JAX result, port result) of the whole slice on ``tri``, each as
    (sorted pairs, total, overflow, num_checks), plus the port's spheres
    and the JAX BVH."""
    needs_jax()
    js = jb.bsphere_from_triangles(*[jnp.asarray(p) for p in tri])
    jbvh = jb.build(js, jb.BBox)
    jout = jb.traverse_tiles_fixed(jbvh, capacity,
                                   alg=jb.TileTraversal(**params),
                                   narrow=narrow)
    ts = tb.bsphere_from_triangles(*[torch.from_numpy(p) for p in tri])
    tout = tb.traverse_tiles_fixed(tb.build(ts), capacity,
                                   alg=tb.TileTraversal(**params),
                                   narrow=narrow)
    summary = [(pairs(c, t), int(t), int(o), float(nc))
               for t, c, o, nc in (jout, tout)]
    return summary[0], summary[1], ts, jbvh


SLICES = {  # (triangles, seed, traversal parameters, capacity)
    "2048_tile32": (2048, 0, dict(tile=32, count_w=2), 4096),
    "5000_tile128": (5000, 1, dict(tile=128), 4096),
}


@pytest.fixture(scope="module", params=sorted(SLICES))
def slice_run(request):
    n, seed, params, capacity = SLICES[request.param]
    tri = triangles(n, seed)
    return (request.param, params, capacity) + run_both(tri, capacity,
                                                        params)


def test_slice_matches_jax_and_brute_force(slice_run):
    name, _, _, want, got, ts, _ = slice_run
    assert got == want
    total, overflow = got[1], got[2]
    assert overflow == 0 and total > 0
    bf = brute_force(np.stack([x.numpy() for x in ts.xs], 1), ts.r.numpy())
    assert set(got[0]) == bf and len(got[0]) == total
    if name == "2048_tile32":
        assert len(ts.r) // 32 == 64     # two supertiles of 32 tiles


def test_traversal_of_the_jax_bvh(slice_run):
    """The JAX package's BVH carried across gives the same result through
    the port's traversal: build and traversal agree separately."""
    _, params, capacity, want, _, _, jbvh = slice_run
    d = {"leaf_kind": "sphere", "index": np.asarray(jbvh.leaves.index),
         "morton": np.asarray(jbvh.leaves.morton),
         "skips": np.asarray(jbvh.skips), "built_level": jbvh.built_level,
         "num_leaves": jbvh.num_leaves,
         "leaf_r": np.asarray(jbvh.leaves.volume.r)}
    for k in range(3):
        d[f"leaf_x{k}"] = np.asarray(jbvh.leaves.volume.xs[k])
        d[f"node_lo{k}"] = np.asarray(jbvh.nodes.los[k])
        d[f"node_up{k}"] = np.asarray(jbvh.nodes.ups[k])
    t, c, o, nc = tb.traverse_tiles_fixed(interop.bvh_from_numpy(d, CPU),
                                          capacity,
                                          alg=tb.TileTraversal(**params))
    assert (pairs(c, t), int(t), int(o), float(nc)) == want


def test_narrow_predicate_matches_jax():
    def narrow(l1, l2):
        return (l1.index + l2.index) % 3 != 0

    params = dict(tile=32, count_w=2, emit_w=2)
    want, got, ts, _ = run_both(triangles(1024, 3), 2048, params, narrow)
    assert got == want and got[2] == 0
    bf = brute_force(np.stack([x.numpy() for x in ts.xs], 1), ts.r.numpy())
    assert set(got[0]) == {(i, j) for i, j in bf if (i + j) % 3}


def test_dense_scene_overflow_bits_match_jax():
    """The dense cluster of the JAX package's growth test overflows the
    slot caps; both packages report the same overflow bits."""
    needs_jax()
    xs, rs = spheres(96, 5, 0.8)
    params = dict(tile=32, row_cap=2, pair_cap=4, count_w=2, emit_w=2)
    jout = jb.traverse_tiles_fixed(
        jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox),
        1024, alg=jb.TileTraversal(**params))
    tout = tb.traverse_tiles_fixed(
        tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))),
        1024, alg=tb.TileTraversal(**params))
    assert int(jout[2]) == int(tout[2]) == 2
    assert int(jout[0]) == int(tout[0])
    assert float(jout[3]) == float(tout[3])


def test_growth_wrapper_matches_jax():
    """Slot-cap growth from row_cap 2 / pair_cap 4 ends, in both packages,
    with the same contacts and the same grown caps (on the two-phase
    route: pair_cap stays <= 128)."""
    needs_jax()
    xs, rs = spheres(200, 5, 3.0)
    params = dict(tile=32, row_cap=2, pair_cap=4, count_w=2, emit_w=2)
    jt = jb.traverse_tiles(
        jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox),
        alg=jb.TileTraversal(**params),
        options=jb.BVHOptions(min_capacity=1024))
    tt = tb.traverse_tiles(
        tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))),
        alg=tb.TileTraversal(**params),
        options=tb.BVHOptions(min_capacity=1024))
    assert sorted(tt.contacts_list()) == sorted(jt.contacts_list())
    assert set(tt.contacts_list()) == brute_force(xs, rs)
    assert (tt.tile_alg.row_cap, tt.tile_alg.pair_cap) == \
        (jt.tile_alg.row_cap, jt.tile_alg.pair_cap) == (32, 64)
    assert tt.num_checks == jt.num_checks
    assert tt.pair_capacity == jt.pair_capacity
    assert tuple(tt.cache1.shape) == tuple(jt.cache1.shape)


def test_merge_streams_matches_jax():
    """Several dense streams concatenate as in the JAX package, including
    a grand total past the capacity."""
    needs_jax()
    from implicitbvh_tpu.traverse.tiles import _merge_streams as jax_merge
    from implicitbvh_tpu_torch.traverse.tiles import _merge_streams
    rng = np.random.default_rng(0)
    for totals, capacity in (((10, 0, 37), 128), ((60, 50, 40), 128)):
        parts = [(rng.integers(0, 1 << 20, 64).astype(np.int32),
                  rng.integers(0, 1 << 20, 64).astype(np.int32), t)
                 for t in totals]
        want = jax_merge([(jnp.asarray(a, jnp.float32),
                           jnp.asarray(b, jnp.float32), jnp.int32(t))
                          for a, b, t in parts], capacity)
        got = _merge_streams([(torch.from_numpy(a), torch.from_numpy(b),
                               torch.tensor(t, dtype=torch.int32))
                              for a, b, t in parts], capacity)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("query", ["self", "pair", "rays", "sharded"])
def test_every_front_end_refuses_past_65536_tiles(query):
    """One check holds every front end to tile indices below 2^16 (they
    are packed 16 bits to a word): 2^18 leaves, or 2^18 rays, in tiles of
    4 raise ``ValueError`` before any kernel runs."""
    from implicitbvh_tpu_torch.parallel import sharding
    g = torch.Generator().manual_seed(0)
    x = torch.rand(3, 1 << 18, generator=g) * 100
    big = tb.build(tb.BSphere(tuple(x), torch.full((1 << 18,), 0.1)))
    small = tb.build(tb.BSphere(tuple(x[:, :100]), torch.full((100,), 0.1)))
    alg = tb.TileTraversal(tile=4, bands=4)
    run = {"self": lambda: tb.traverse_tiles_fixed(big, 1024, alg=alg),
           "pair": lambda: tb.traverse_tiles_pair_fixed(small, big, 1024,
                                                        alg=alg),
           "rays": lambda: tb.traverse_rays_tiles_fixed(small, x, x, 1024,
                                                        alg=alg),
           "sharded": lambda: sharding._local_sharded_tile_self_contact(
               big, 1024, 0, 2, alg=alg)}[query]
    with pytest.raises(ValueError, match="tile count exceeds 65536"):
        run()


def test_readme_demo():
    xs = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4]],
                  np.float32)
    rs = np.array([0.5, 0.6, 0.5, 0.4, 0.6], np.float32)
    bvh = tb.build(tb.BSphere(xs, rs, device="cpu"))
    t = tb.traverse_tiles(bvh)
    assert t.contacts_list() == [(1, 2), (2, 3), (4, 5)]


@pytest.mark.gpu
def test_build_on_card_matches_cpu():
    """Spheres, Morton order and BBox nodes built on the card equal the
    CPU build bit for bit (every float operation is correctly rounded on
    both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tri = triangles(5000, 1)
    a, b = (tb.build(tb.bsphere_from_triangles(*tri, device=d))
            for d in ("cuda", "cpu"))
    for x, y in zip([a.leaves.index, a.leaves.morton, *a.leaves.volume.xs,
                     a.leaves.volume.r, *a.nodes.los, *a.nodes.ups],
                    [b.leaves.index, b.leaves.morton, *b.leaves.volume.xs,
                     b.leaves.volume.r, *b.nodes.los, *b.nodes.ups]):
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
def test_slice_on_card_matches_cpu():
    """The whole slice on the card (CUDA kernels) equals the port on the
    CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tri = triangles(5000, 1)
    res = []
    for dev in ("cuda", "cpu"):
        s = tb.bsphere_from_triangles(*tri, device=dev)
        t, c, o, nc = tb.traverse_tiles_fixed(tb.build(s), 4096)
        res.append((pairs(c.cpu(), t), int(t), int(o), float(nc)))
    assert res[0] == res[1]
