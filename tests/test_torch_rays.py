"""Batch ray queries of the port against the JAX package, on the CPU.

Leaves and rays made by numpy from a seed go through ``build`` and the ray
entry points of both packages (``traverse_rays``, ``traverse_rays_tiles``,
``traverse_rays_tiles_fixed``): the JAX package's Pallas kernels run in
interpret mode, the port's kernels as their plain PyTorch versions.  The
scenes are those of ``tests/test_ray_tiles.py``.  The hit sets, the totals,
the overflow bits, ``num_checks`` and the grown capacities must agree
exactly (tolerance 0): every predicate compares identically rounded float32
values and every count is an integer.  The order of the hits inside the
list is not compared: it is not part of the contract.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.raytrace import traverse_rays as jax_traverse_rays
    from implicitbvh_tpu.traverse import ray_tiles as jray
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import interop
from implicitbvh_tpu_torch.traverse import ray_tiles as tray

CPU = torch.device("cpu")


def needs_jax():
    if jb is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def random_scene(n, seed, scale=None):
    rng = np.random.default_rng(seed)
    scale = scale or float(n) ** (1.0 / 3.0) * 1.5
    xs = rng.random((n, 3)).astype(np.float32) * scale
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    return xs, rs


def random_rays(nrays, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    p = (rng.random((3, nrays)).astype(np.float32) * (scale + 3) - 1.5)
    d = (rng.random((3, nrays)).astype(np.float32) - 0.5)
    return p, d


def both_bvhs(kind, a, b):
    """The JAX and the port's BVH over spheres (centres, radii) or boxes
    (lower, upper corners)."""
    needs_jax()
    if kind == "sphere":
        return (jb.build(jb.BSphere(jnp.asarray(a), jnp.asarray(b)), jb.BBox),
                tb.build(tb.BSphere(a, b, device=CPU)))
    return (jb.build(jb.BBox(jnp.asarray(a), jnp.asarray(b)), jb.BBox),
            tb.build(tb.BBox(a, b, device=CPU)))


def brute_force(kind, a, b, p, d):
    """1-based (leaf, ray) hits of ``isintersection`` of every ray against
    every leaf."""
    vol = (tb.BSphere(a[:, None, :], b[:, None], device=CPU)
           if kind == "sphere" else tb.BBox(a[:, None, :], b[:, None, :],
                                            device=CPU))
    pt, dt = interop.rays_from_numpy(p, d, CPU)
    hit = tb.isintersection(vol, tuple(x[None, :] for x in pt),
                            tuple(x[None, :] for x in dt))
    return {(int(i) + 1, int(k) + 1) for i, k in hit.nonzero().tolist()}


def summary(t):
    """What two growth-wrapper results must share."""
    return (sorted(t.contacts_list()), int(t.num_contacts), t.num_checks,
            t.pair_capacity, tuple(t.cache1.shape),
            (t.tile_alg.row_cap, t.tile_alg.pair_cap, t.tile_alg.decode_k,
             t.tile_alg.emit_w))


def fixed_summary(out):
    total, contacts, overflow, nc = out
    n = min(int(total), contacts.shape[0])
    return (sorted(map(tuple, np.asarray(contacts)[:n].tolist())),
            int(total), int(overflow), float(nc))


def test_ray_tiles_matches_jax_sphere_leaves():
    xs, rs = random_scene(300, 0)
    p, d = random_rays(77, 1, scale=float(300) ** (1 / 3) * 1.5)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    want = summary(jray.traverse_rays_tiles(jbvh, p, d))
    got = summary(tb.traverse_rays_tiles(tbvh, p, d))
    assert got == want
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)
    assert got[1] > 0 and got[4] == (512, 2)      # the fallback route


def test_ray_tiles_matches_jax_box_leaves():
    rng = np.random.default_rng(3)
    lo = rng.random((200, 3)).astype(np.float32) * 8
    up = lo + rng.random((200, 3)).astype(np.float32) * 0.7
    p, d = random_rays(50, 4, scale=8.0)
    jbvh, tbvh = both_bvhs("box", lo, up)
    want = summary(jray.traverse_rays_tiles(jbvh, p, d))
    got = summary(tb.traverse_rays_tiles(tbvh, p, d))
    assert got == want
    assert set(got[0]) == brute_force("box", lo, up, p, d) and got[1] > 0


def test_traverse_rays_dispatch():
    """``traverse_rays`` with ``TileTraversal()`` takes row_cap 8; with no
    algorithm the port takes the tile engine too; ``LVTTraversal()`` takes
    the walk and ``BFSTraversal()`` the breadth-first frontier (the same
    hit set)."""
    xs, rs = random_scene(100, 5)
    p, d = random_rays(33, 6)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    want = summary(jax_traverse_rays(jbvh, p, d, jb.TileTraversal()))
    got = summary(tb.traverse_rays(tbvh, p, d, tb.TileTraversal()))
    assert got == want and got[5] == (8, 32, 0, 4)
    assert summary(tb.traverse_rays(tbvh, p, d)) == got
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)
    walk = tb.traverse_rays(tbvh, p, d, tb.LVTTraversal())
    assert sorted(walk.contacts_list()) == got[0] and walk.tile_alg is None
    bfs = tb.traverse_rays(tbvh, p, d, tb.BFSTraversal())
    assert sorted(bfs.contacts_list()) == got[0] and bfs.tile_alg is None
    with pytest.raises(ValueError):
        tb.traverse_rays(tbvh, p, d, start_level=99)
    with pytest.raises(ValueError):
        tb.traverse_rays(tbvh, p.T, d.T)
    empty = tb.traverse_rays(tbvh, p[:, :0], d[:, :0])
    assert empty.num_contacts == 0 and tuple(empty.cache1.shape) == (0, 2)


@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_axis_aligned_and_zero_direction_components(kind):
    """Rays along the axes, a zero direction and, with box leaves, a ray
    lying in a face plane (its slab is 0 * inf = NaN): the select min/max
    of the reference decides these."""
    xs = np.array([[0, 0, z] for z in range(6)], np.float32)
    rs = np.full(6, 0.4, np.float32)
    p = np.array([[0.0, 0.0, 10.0], [0.0, 0.0, 0.0], [-5.0, 20.0, 2.0],
                  [0.4, 0.0, 10.0], [-0.4, 0.4, -3.0]], np.float32).T.copy()
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                  [0.0, 0.0, -1.0], [0.0, 0.0, 2.0]], np.float32).T.copy()
    if kind == "sphere":
        a, b = xs, rs
    else:
        a, b = xs - rs[:, None], xs + rs[:, None]
    jbvh, tbvh = both_bvhs(kind, a, b)
    want = summary(jray.traverse_rays_tiles(jbvh, p, d))
    got = summary(tb.traverse_rays_tiles(tbvh, p, d))
    assert got == want
    assert {(i, 1) for i in range(1, 7)} <= set(got[0])
    assert set(got[0]) == brute_force(kind, a, b, p, d)


def test_narrow_predicate_matches_jax():
    xs, rs = random_scene(120, 7)
    p, d = random_rays(40, 8)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)

    def narrow(leaf, pp, dd):
        return leaf.index % 2 == 0

    want = summary(jray.traverse_rays_tiles(jbvh, p, d, narrow=narrow))
    got = summary(tb.traverse_rays_tiles(tbvh, p, d, narrow=narrow))
    assert got == want
    assert set(got[0]) == {h for h in brute_force("sphere", xs, rs, p, d)
                           if h[0] % 2 == 0}


def test_fixed_overflow_flag_matches_jax():
    """Capacity 4 overflows bit 0; large slot caps and capacity do not."""
    xs, rs = random_scene(64, 9, scale=2.0)
    p, d = random_rays(32, 10, scale=2.0)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    jout = jray.traverse_rays_tiles_fixed(jbvh, p, d, 4)
    tout = tb.traverse_rays_tiles_fixed(tbvh, p, d, 4)
    assert (int(tout[0]), int(tout[2]), float(tout[3])) == \
        (int(jout[0]), int(jout[2]), float(jout[3]))
    assert int(tout[0]) > 4 and int(tout[2]) & 1
    big = dict(row_cap=16, pair_cap=256)
    want = fixed_summary(jray.traverse_rays_tiles_fixed(
        jbvh, p, d, 1 << 12, alg=jb.TileTraversal(**big)))
    got = fixed_summary(tb.traverse_rays_tiles_fixed(
        tbvh, p, d, 1 << 12, alg=tb.TileTraversal(**big)))
    assert got == want and got[2] == 0
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)


def test_more_rays_than_leaves():
    """300 rays start at capacity 2048: the two-phase route with the ray
    defaults (decode_k 8)."""
    xs, rs = random_scene(40, 11)
    p, d = random_rays(300, 12)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    want = summary(jray.traverse_rays_tiles(jbvh, p, d))
    got = summary(tb.traverse_rays_tiles(tbvh, p, d))
    assert got == want and got[4][0] % 1024 == 0
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)


def test_fine_bands_two_phase():
    """bands=16 on the two-phase route, tile 32, without the moment decode
    (every pair with hits goes through the emit kernel)."""
    rng = np.random.default_rng(21)
    n, nrays = 400, 96
    xs = (rng.random((n, 3)) * 8).astype(np.float32)
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    p = (rng.random((3, nrays)) * 8).astype(np.float32)
    d = (rng.random((3, nrays)) - 0.5).astype(np.float32)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    params = dict(tile=32, row_cap=16, pair_cap=128, bands=16, count_w=2,
                  emit_w=2)
    want = fixed_summary(jray.traverse_rays_tiles_fixed(
        jbvh, p, d, capacity=1024, alg=jb.TileTraversal(**params)))
    got = fixed_summary(tb.traverse_rays_tiles_fixed(
        tbvh, p, d, 1024, alg=tb.TileTraversal(**params)))
    assert got == want and got[2] == 0
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)


def test_two_phase_box_leaves_default_alg():
    """Box leaves with the ray defaults (tile 128, row_cap 8, emit_w 8,
    decode_k 8) on the two-phase route: the ray_box mask through the count
    kernel's moments, the decode and the emit kernel."""
    rng = np.random.default_rng(31)
    n, nrays = 700, 260
    xs = (rng.random((n, 3)) * 12).astype(np.float32)
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    p = (rng.random((3, nrays)) * 12).astype(np.float32)
    d = (rng.random((3, nrays)) - 0.5).astype(np.float32)
    a, b = xs - rs[:, None], xs + rs[:, None]
    jbvh, tbvh = both_bvhs("box", a, b)
    want = fixed_summary(jray.traverse_rays_tiles_fixed(jbvh, p, d, 4096))
    got = fixed_summary(tb.traverse_rays_tiles_fixed(tbvh, p, d, 4096))
    assert got == want and got[2] == 0 and got[1] > 100
    assert set(got[0]) == brute_force("box", a, b, p, d)


def test_growth_into_the_fallback():
    """Slot caps of 8 and 16 on a dense scene (parallel rays through a
    cluster) start on the two-phase route and grow past pair_cap 128: both
    packages end on the fallback with the same caps and hits."""
    needs_jax()
    rng = np.random.default_rng(9)
    xs = rng.random((64, 3)).astype(np.float32) * 1.5
    rs = (rng.random(64) * 0.3 + 0.05).astype(np.float32)
    p = np.stack([rng.random(64) * 1.5, rng.random(64) * 1.5,
                  np.full(64, -3.0)]).astype(np.float32)
    d = np.stack([(rng.random(64) - 0.5) * 0.1, (rng.random(64) - 0.5) * 0.1,
                  np.ones(64)]).astype(np.float32)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    params = dict(tile=32, row_cap=8, pair_cap=16, count_w=2, emit_w=2)
    want = summary(jray.traverse_rays_tiles(
        jbvh, p, d, alg=jb.TileTraversal(**params),
        options=jb.BVHOptions(min_capacity=1024)))
    got = summary(tb.traverse_rays_tiles(
        tbvh, p, d, alg=tb.TileTraversal(**params),
        options=tb.BVHOptions(min_capacity=1024)))
    assert got == want and got[5][:2] == (32, 256) and got[4] == (1024, 2)
    assert set(got[0]) == brute_force("sphere", xs, rs, p, d)


def test_sort_rays_and_tile_hits_match_jax():
    """The coherence sort's permutation and phase 1's band-bit matrix."""
    needs_jax()
    xs, rs = random_scene(500, 13)
    p, d = random_rays(333, 14)
    d[:, :40] = np.sign(d[:, :40])           # ties between direction bins
    p[:, 5:25] = p[:, 5:6]                   # equal origins: input order
    d[2, 30:50] = 0.0
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    jp, jd = tuple(jnp.asarray(p)), tuple(jnp.asarray(d))
    tp, td = (tuple(x) for x in interop.rays_from_numpy(p, d, CPU))
    jperm = jray._sort_rays(jp, jd)
    tperm = tray._sort_rays(tp, td)
    assert np.array_equal(np.asarray(jperm), tperm.numpy())
    for G, NB in ((32, 4), (32, 16), (128, 4)):
        jrf, jRT = jray._ray_tile_fields(jp, jd, jperm, G)
        trf, tRT = tray._ray_tile_fields(tp, td, tperm, G)
        assert jRT == tRT
        assert np.array_equal(np.stack([np.asarray(f) for f in jrf]),
                              trf.numpy(), equal_nan=True)
        _, _, tlo, tup, _, _, _ = jray._tiled_fields(jbvh, G)
        _, _, tiles, _, _ = tray._tiled_fields(tbvh, G)
        want = np.asarray(jray._ray_tile_hits(jrf, tlo, tup, NB))
        got = tray._ray_tile_hits(trf, tiles, NB)
        assert np.array_equal(want, got.numpy()) and int(got.sum()) > 0


def test_self_contact_decode_matches_jax():
    """Tile self-contact through the moment decode (decode_k=8) equals the
    JAX package and the port's own decode_k=0 result."""
    needs_jax()
    params = dict(tile=32, count_w=2, decode_k=8)
    rng = np.random.default_rng(2)
    n = 3000
    xs = (rng.random((n, 3)) * 13.0).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    jbvh, tbvh = both_bvhs("sphere", xs, rs)
    want = fixed_summary(jb.traverse_tiles_fixed(
        jbvh, 4096, alg=jb.TileTraversal(**params)))
    got = fixed_summary(tb.traverse_tiles_fixed(
        tbvh, 4096, alg=tb.TileTraversal(**params)))
    assert got == want and got[2] == 0 and got[1] > 0
    plain = fixed_summary(tb.traverse_tiles_fixed(
        tbvh, 4096, alg=tb.TileTraversal(**dict(params, decode_k=0))))
    assert got == plain


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_rays_on_card_match_cpu(kind):
    """Both ray routes on the card (CUDA kernels) equal the port on the CPU
    (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(41)
    n, nrays = 5000, 3000
    xs = (rng.random((n, 3)) * 20).astype(np.float32)
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    p = (rng.random((3, nrays)) * 20).astype(np.float32)
    d = (rng.random((3, nrays)) - 0.5).astype(np.float32)
    d[0, :50] = 0.0
    two_phase = dict(row_cap=8, pair_cap=64, emit_w=8)
    for alg in (tb.TileTraversal(decode_k=8, **two_phase),
                tb.TileTraversal(**two_phase),
                tb.TileTraversal(row_cap=32, pair_cap=512)):
        res = []
        for dev in ("cuda", "cpu"):
            vol = (tb.BSphere(xs, rs, device=dev) if kind == "sphere" else
                   tb.BBox(xs - rs[:, None], xs + rs[:, None], device=dev))
            out = tb.traverse_rays_tiles_fixed(tb.build(vol), p, d, 1 << 15,
                                               alg=alg)
            res.append(fixed_summary(tuple(x.cpu() for x in out)))
        assert res[0] == res[1] and res[0][2] == 0 and res[0][1] > 0
