"""Two-tree contact, mixed precisions and rays on the tile engine in
float64, against the JAX package with x64, on the CPU.

The scenes of ``test_torch_tiles_f64.py``: 2,500 random spheres (bvh1)
against 1,200 more (bvh2), and 200 rays, in float64.  One call of the JAX
package's tile engine each (its fallback route) gives the reference for
two float64 trees, for a float32 bvh1 against the float64 bvh2 (the JAX
package promotes inside its kernels; the port widens the float32 tree's
fields and bounds to float64 first, which is exact) and for the rays
against sphere leaves; the JAX package's walk gives it for box leaves.
The port runs both routes, both tree orders of the mixed pair, rays with
no algorithm, and the sharded local functions at 8 ranks (against its own
single-device float64 answer).  Tolerance: exact; sets compared as sorted
lists (the order inside a tile pair and of ray hits is not part of the
contract).  The ``gpu`` case holds the card's ``<double>`` kernels against
the CPU on these scenes.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.traverse import TileTraversal as JTile
    from implicitbvh_tpu.traverse import ray_tiles as jrays
    from implicitbvh_tpu.traverse import tiles as jtiles
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch.parallel import sharding as ts
from test_torch_tiles_f64 import (CAP, FALLBACK, G, N_DEV, ROUTES, TWO_PHASE,
                                  jax_bvh, pairs, port_bvh, spheres, summary,
                                  to_port)

RAY_ROUTES = {"two_phase": dict(TWO_PHASE, emit_w=8, decode_k=8),
              "fallback": FALLBACK}


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def ray_scene(n=200, seed=5):
    """(3, n) float64 rays across the scene; an eighth of the direction
    components are zero."""
    rng = np.random.default_rng(seed)
    p = rng.random((3, n)) * 14.0
    d = rng.random((3, n)) - 0.5
    d[rng.random((3, n)) < 0.125] = 0.0
    return p, d


def box_bvh_jax(xs, rs):
    return jb.build(jb.BBox(jnp.asarray(xs - rs[:, None]),
                            jnp.asarray(xs + rs[:, None])), jb.BBox)


def box_bvh_port(xs, rs, device="cpu"):
    return tb.build(tb.BBox(torch.from_numpy(xs - rs[:, None]),
                            torch.from_numpy(xs + rs[:, None]),
                            device=device), tb.BBox)


def ray_hits(res):
    return sorted(res.contacts_list())


@pytest.fixture(scope="module")
def trees():
    """bvh1 in float64 and in float32 and bvh2 in float64, in both
    packages (the port's carried from the JAX package's)."""
    xs1, rs1 = spheres(2500, 0)
    xs2, rs2 = spheres(1200, 1)
    j64, j32 = jax_bvh(xs1, rs1), jax_bvh(xs1.astype(np.float32),
                                          rs1.astype(np.float32))
    j2 = jax_bvh(xs2, rs2)
    return dict(jax=(j64, j32, j2),
                port=(to_port(j64), to_port(j32), to_port(j2)))


@pytest.fixture(scope="module")
def pair_want(trees):
    j64, _, j2 = trees["jax"]
    return summary(jtiles.traverse_tiles_pair_fixed(j64, j2, CAP,
                                                    alg=JTile(**FALLBACK)))


@pytest.fixture(scope="module")
def mixed_want(trees):
    _, j32, j2 = trees["jax"]
    return summary(jtiles.traverse_tiles_pair_fixed(j32, j2, CAP,
                                                    alg=JTile(**FALLBACK)))


@pytest.mark.parametrize("route", ["two_phase", "fallback"])
def test_pair_matches_jax(trees, pair_want, route):
    """Two float64 trees: the set on both routes, and on the fallback the
    total, overflow bits and ``num_checks`` too."""
    t64, _, t2 = trees["port"]
    got = summary(tb.traverse_tiles_pair_fixed(
        t64, t2, CAP, alg=tb.TileTraversal(**ROUTES[route])))
    assert got[0] == pair_want[0] and got[2] == 0
    assert 200 < pair_want[1] < CAP
    if route == "fallback":
        assert got == pair_want


@pytest.mark.parametrize("route", ["two_phase", "fallback"])
def test_mixed_pair_matches_jax(trees, mixed_want, route):
    """A float32 bvh1 against the float64 bvh2, and the reverse order (the
    JAX set transposed): the JAX package's promoted set."""
    _, t32, t2 = trees["port"]
    alg = tb.TileTraversal(**ROUTES[route])
    got = summary(tb.traverse_tiles_pair_fixed(t32, t2, CAP, alg=alg))
    assert got[0] == mixed_want[0] and got[2] == 0
    if route == "fallback":
        assert got == mixed_want
    rev = summary(tb.traverse_tiles_pair_fixed(t2, t32, CAP, alg=alg))
    assert rev[0] == sorted((j, i) for i, j in mixed_want[0])


def test_traverse_two_trees_takes_float64(trees, pair_want, mixed_want):
    """``traverse(bvh1, bvh2, TileTraversal())`` with growth, both
    precisions."""
    t64, t32, t2 = trees["port"]
    alg = tb.TileTraversal(tile=G)
    assert sorted(tb.traverse(t64, t2, alg).contacts_list()) == pair_want[0]
    assert sorted(tb.traverse(t32, t2, alg).contacts_list()) == \
        mixed_want[0]


@pytest.fixture(scope="module")
def rays_want(trees):
    """The JAX package's hit set of the float64 rays, sphere leaves."""
    j64 = trees["jax"][0]
    p, d = ray_scene()
    t, c, o, _ = jrays.traverse_rays_tiles_fixed(
        j64, jnp.asarray(p), jnp.asarray(d), CAP, alg=JTile(**FALLBACK))
    assert int(o) == 0
    return pairs(t, c)


@pytest.mark.parametrize("route", sorted(RAY_ROUTES))
def test_rays_match_jax(trees, rays_want, route):
    """Float64 rays through both routes (the two-phase one with the moment
    decode) give the JAX package's hits."""
    t64 = trees["port"][0]
    p, d = ray_scene()
    t, c, o, _ = tb.traverse_rays_tiles_fixed(
        t64, p, d, CAP, alg=tb.TileTraversal(**RAY_ROUTES[route]))
    assert int(o) == 0 and 100 < int(t)
    assert pairs(t, c) == rays_want


def test_rays_with_no_algorithm_match_jax(trees, rays_want):
    """``traverse_rays(bvh, p, d)`` on CPU tensors takes the tile engine,
    in float64, and gives the JAX package's hits."""
    p, d = ray_scene()
    res = tb.traverse_rays(trees["port"][0], p, d)
    assert ray_hits(res) == rays_want


def test_box_leaf_rays_match_jax():
    """Float64 rays against box leaves (the ray_box mask, zero direction
    components) on both routes and with no algorithm, against the JAX
    package's walk."""
    xs, rs = spheres(2500, 0)
    p, d = ray_scene()
    want = ray_hits(jb.traverse_rays(box_bvh_jax(xs, rs), jnp.asarray(p),
                                     jnp.asarray(d), jb.LVTTraversal()))
    tbvh = box_bvh_port(xs, rs)
    assert ray_hits(tb.traverse_rays(tbvh, p, d)) == want
    for route, params in RAY_ROUTES.items():
        t, c, o, _ = tb.traverse_rays_tiles_fixed(
            tbvh, p, d, CAP, alg=tb.TileTraversal(**params))
        assert int(o) == 0 and pairs(t, c) == want, route


def _sharded(local_fn, *args, **kw):
    rows, total = [], 0
    for rank in range(N_DEV):
        t, c, o = local_fn(*args, 1024, rank, N_DEV, **kw)
        assert not bool(o), rank
        rows += pairs(t, c)
        total += int(t)
    assert total == len(rows) == len(set(rows))
    return sorted(rows)


def test_sharded_pair_and_rays_at_8_ranks(trees):
    """The ranks' slices of the float64 pair, the mixed pair and the rays
    make the port's single-device float64 sets."""
    t64, t32, t2 = trees["port"]
    alg = tb.TileTraversal(**TWO_PHASE)
    for a, b in ((t64, t2), (t32, t2)):
        want = pairs(*tb.traverse_tiles_pair_fixed(a, b, CAP, alg=alg)[:2])
        assert _sharded(ts._local_sharded_tile_pair, a, b, alg=alg) == want
    p, d = ray_scene()
    want = pairs(*tb.traverse_rays_tiles_fixed(t64, p, d, CAP)[:2])
    assert _sharded(ts._local_sharded_rays, t64, p, d) == want


@pytest.mark.gpu
def test_float64_pair_and_rays_on_card_equal_cpu():
    """The ``<double>`` kernels: two float64 trees, both orders of the
    mixed pair, rays against spheres and boxes, on both routes; the card's
    results equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from implicitbvh_tpu_torch import ops
    xs1, rs1 = spheres(2500, 0)
    xs2, rs2 = spheres(1200, 1)
    x32, r32 = xs1.astype(np.float32), rs1.astype(np.float32)

    def both(fn):
        return fn("cpu"), fn("cuda")

    trees = {
        "f64": both(lambda dev: (port_bvh(xs1, rs1, device=dev),
                                 port_bvh(xs2, rs2, device=dev))),
        "f32_f64": both(lambda dev: (port_bvh(x32, r32, device=dev),
                                     port_bvh(xs2, rs2, device=dev))),
        "f64_f32": both(lambda dev: (port_bvh(xs2, rs2, device=dev),
                                     port_bvh(x32, r32, device=dev)))}
    for name, (cpu, gpu) in trees.items():
        for route in ("two_phase", "fallback"):
            alg = tb.TileTraversal(**ROUTES[route])
            ops.reset_launch_counts()
            got = summary(tb.traverse_tiles_pair_fixed(*gpu, CAP, alg=alg))
            assert ops.launch_count(ops.subtile_band_bits) == 1, \
                (name, route)
            assert got == summary(tb.traverse_tiles_pair_fixed(
                *cpu, CAP, alg=alg)), (name, route)
    p, d = ray_scene()
    for leaves in (port_bvh, box_bvh_port):
        cpu, gpu = leaves(xs1, rs1), leaves(xs1, rs1, device="cuda")
        for route, params in RAY_ROUTES.items():
            alg = tb.TileTraversal(**params)
            ops.reset_launch_counts()
            t, c, o, n = tb.traverse_rays_tiles_fixed(gpu, p, d, CAP,
                                                      alg=alg)
            launched = ops.launch_count(
                ops.tile_run_counts if route == "two_phase"
                else ops.tile_group_contacts)
            assert launched == 1, (leaves.__name__, route)
            tc, cc, oc, nc = tb.traverse_rays_tiles_fixed(cpu, p, d, CAP,
                                                          alg=alg)
            assert (int(t), int(o), float(n)) == (int(tc), int(oc),
                                                  float(nc))
            assert pairs(t, c) == pairs(tc, cc), (leaves.__name__, route)
