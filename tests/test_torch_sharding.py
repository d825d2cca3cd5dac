"""Sharded self-contact of the port against the JAX package's
``implicitbvh_tpu.parallel``, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(the Pallas kernels in interpret mode), on the scenes and parameters of
``tests/test_sharding.py``, each scene once per module.  The port's
collective-free local functions (``_local_<name>(..., rank, n_dev)``) run
for ranks 0..7 in this process (the kernels as their plain PyTorch
versions).  Tolerance: exact.  Totals, per-rank counts and the overflow
bool must be equal; the walk engine's global buffer row by row; the tile
engine's rank slices as sorted lists (inside a tile pair the emit order
differs between the packages, ``docs/port_parity.md``).  Also held: the
superpair list with the sharded rounding, the raises, the public names and
arguments, and ``make_mesh``'s raises.  Two-tree contact, rays, the step
and the process-group worlds are in ``test_torch_sharding_pair_rays.py``.
"""

import inspect

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import parallel as jpar
    from implicitbvh_tpu.traverse import TileTraversal as JTile
    from implicitbvh_tpu.traverse import tiles as jtiles
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import parallel as tpar
from implicitbvh_tpu_torch.parallel import sharding as ts
from implicitbvh_tpu_torch.traverse import tiles as ttiles

N_DEV = 8
TILE32 = dict(tile=32)
TILE32_WIDE = dict(tile=32, row_cap=8, pair_cap=64)


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def spheres(n, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 3), dtype=np.float32) * scale
    rs = (rng.random(n, dtype=np.float32) * 0.4 + 0.05).astype(np.float32)
    return xs, rs


def ray_scene():
    """``test_sharding.py``'s ray scene: 64 spheres, 16 rays."""
    rng = np.random.default_rng(1)
    xs, rs = spheres(64, 2)
    p = (rng.random((3, 16)).astype(np.float32) * 8 - 1.5)
    d = (rng.random((3, 16)).astype(np.float32) - 0.5)
    return xs, rs, p, d


def dryrun_scene(n_dev=8):
    """The inputs of ``__graft_entry__.dryrun_multichip(8)``: 512 spheres
    (``_example_spheres(n, seed=1)``), 64 rays of ``default_rng(2)`` and the
    second body (``seed=3``)."""
    def example(n, seed):
        rng = np.random.default_rng(seed)
        scale = float(n) ** (1.0 / 3.0)
        xs = (rng.random((n, 3)) * scale).astype(np.float32)
        rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
        return xs, rs
    n = 64 * n_dev
    x, r = example(n, 1)
    rng = np.random.default_rng(2)
    p = rng.random((3, 8 * n_dev)).astype(np.float32) * 4 - 1
    d = rng.random((3, 8 * n_dev)).astype(np.float32) - 0.5
    x2, r2 = example(n, 3)
    return dict(x=x, r=r, p=p, d=d, x2=x2, r2=r2)


def brute_force(xs, rs, xs2=None, rs2=None):
    """1-based pairs in contact: ``(i, j)``, i < j, of one set, or every
    ``(i, j)`` of set 1 against set 2."""
    other = xs2 is not None
    xs2, rs2 = (xs2, rs2) if other else (xs, rs)
    d = [xs[:, None, k] - xs2[None, :, k] for k in range(3)]
    rr = rs[:, None] + rs2[None, :]
    hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
    return {(int(i) + 1, int(j) + 1) for i, j in zip(*np.nonzero(hit))
            if other or i < j}


def port_bvh(xs, rs, device="cpu"):
    return tb.build(tb.BSphere(torch.as_tensor(xs), torch.as_tensor(rs),
                               device=device), tb.BBox)


def jax_bvh(xs, rs):
    return jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox)


def per_rank(local_fn, *args, n_dev=N_DEV, **kw):
    """``local_fn`` for ranks 0..n_dev-1: lists of totals (ints), contact
    slices (tensors) and overflow flags (bools)."""
    outs = [local_fn(*args, rank, n_dev, **kw) for rank in range(n_dev)]
    return ([int(t) for t, _, _ in outs], [c for _, c, _ in outs],
            [bool(o) for _, _, o in outs])


def rank_rows(contacts, count, cap):
    return sorted(map(tuple, np.asarray(contacts)[:min(count, cap)].tolist()))


# --------------------------------------------------------------------------
# the JAX package's 8-device outputs, each computed once per module
# --------------------------------------------------------------------------

def _jax_runs():
    mesh = jpar.make_mesh(jax.devices()[:N_DEV])

    def self_walk(cap):
        return jpar.sharded_self_contact(mesh, jax_bvh(*spheres(128, 42)),
                                         cap)

    def tile_self(cap):
        return jpar.sharded_tile_self_contact(
            mesh, jax_bvh(*spheres(300, 7)), cap, alg=JTile(**TILE32))

    def rays(engine):
        xs, rs, p, d = ray_scene()
        return jpar.sharded_rays(mesh, jax_bvh(xs, rs), p, d, 128,
                                 engine=engine)

    def step():
        xs, rs = spheres(128, 3)
        fn = jpar.sharded_rebuild_traverse_step(
            mesh, capacity_per_device=256, alg=JTile(**TILE32_WIDE))
        return (fn(jnp.asarray(xs), jnp.asarray(rs)),
                fn(jnp.asarray(xs + 0.1), jnp.asarray(rs)))

    return {
        "walk": lambda: self_walk(256),
        "walk_over": lambda: self_walk(8),
        "tile": lambda: tile_self(256),
        "tile_over": lambda: tile_self(8),
        "spread": lambda: jpar.sharded_tile_self_contact(
            mesh, jax_bvh(*spheres(2048, 11, scale=16.0)), 2048,
            alg=JTile(**TILE32_WIDE)),
        "pair": lambda: jpar.sharded_tile_pair(
            mesh, jax_bvh(*spheres(300, 21)), jax_bvh(*spheres(200, 22)),
            512, alg=JTile(**TILE32_WIDE)),
        "rays_tiles": lambda: rays("tiles"),
        "rays_walk": lambda: rays("walk"),
        "step": step,
    }


@pytest.fixture(scope="module")
def jax_out():
    """``jax_out(name)``: the JAX package's ``(total, contacts, counts,
    overflow)`` of a scene as numpy, run on first use."""
    runs, done = _jax_runs(), {}

    def get(name):
        if name not in done:
            out = runs[name]()
            done[name] = jax.tree_util.tree_map(np.asarray, out)
        return done[name]
    return get


def same_walk(jout, got, cap):
    """The walk engines: totals, counts, overflow and the global buffer row
    by row."""
    jt, jc, jcounts, jov = jout
    totals, contacts, overflows = got
    assert int(jt) == sum(totals)
    assert jcounts.tolist() == totals
    assert bool(jov) == any(overflows)
    assert np.array_equal(jc, torch.cat(contacts).numpy())
    assert jc.shape == (N_DEV * cap, 2)


def same_tiles(jout, got, cap):
    """The tile engines: totals, counts, overflow and each rank's slice as
    a sorted list (the valid prefix of the slice)."""
    jt, jc, jcounts, jov = jout
    totals, contacts, overflows = got
    assert int(jt) == sum(totals)
    assert jcounts.tolist() == totals
    assert bool(jov) == any(overflows)
    for rank, (count, c) in enumerate(zip(totals, contacts)):
        assert c.shape == (cap, 2)
        assert rank_rows(c, count, cap) == \
            rank_rows(jc[rank * cap:(rank + 1) * cap], count, cap)
    return {row for c, n in zip(contacts, totals)
            for row in rank_rows(c, n, cap)}


# --------------------------------------------------------------------------
# 8 ranks against the JAX package's 8 devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [256, 8])
def test_walk_self_contact_matches_jax(jax_out, cap):
    xs, rs = spheres(128, 42)
    got = per_rank(ts._local_sharded_self_contact, port_bvh(xs, rs), cap)
    same_walk(jax_out("walk" if cap == 256 else "walk_over"), got, cap)
    assert any(got[2]) == (cap == 8)
    if cap == 256:
        assert {tuple(r) for c, n in zip(got[1], got[0])
                for r in c[:n].tolist()} == brute_force(xs, rs)


def test_tile_self_contact_matches_jax(jax_out):
    xs, rs = spheres(300, 7)
    got = per_rank(ts._local_sharded_tile_self_contact, port_bvh(xs, rs),
                   256, alg=tb.TileTraversal(**TILE32))
    assert same_tiles(jax_out("tile"), got, 256) == brute_force(xs, rs)
    assert not any(got[2])


def test_tile_self_contact_overflow_matches_jax(jax_out):
    """A capacity of 8 overflows the rank that holds the scene's one
    superpair: the overflow bool, the totals and the counts are the JAX
    package's (the 8 rows kept are a truncated stream, not compared)."""
    got = per_rank(ts._local_sharded_tile_self_contact,
                   port_bvh(*spheres(300, 7)), 8,
                   alg=tb.TileTraversal(**TILE32))
    jt, jc, jcounts, jov = jax_out("tile_over")
    assert bool(jov) and any(got[2])
    assert jcounts.tolist() == got[0] and int(jt) == sum(got[0])
    assert jc.shape == (N_DEV * 8, 2)
    assert all(c.shape == (8, 2) for c in got[1])


def test_tile_self_contact_spreads_as_jax(jax_out):
    """The round-robin deal: the spread scene's contacts lie on several
    ranks, with the JAX package's count on each."""
    xs, rs = spheres(2048, 11, scale=16.0)
    got = per_rank(ts._local_sharded_tile_self_contact, port_bvh(xs, rs),
                   2048, alg=tb.TileTraversal(**TILE32_WIDE))
    assert same_tiles(jax_out("spread"), got, 2048) == brute_force(xs, rs)
    assert sum(n > 0 for n in got[0]) >= 2 and not any(got[2])


def test_raises_as_jax():
    """Leaves or rays not a multiple of the ranks, and ``pair_cap > 128``
    on the tile paths, raise ``ValueError`` in both packages; two-tree
    contact of sphere and box leaves raises ``NotImplementedError`` in both,
    before ``pair_cap`` is checked."""
    mesh = jpar.make_mesh(jax.devices()[:N_DEV])
    xs, rs = spheres(100, 4)
    jbvh, tbvh = jax_bvh(xs, rs), port_bvh(xs, rs)
    lo, up = xs - rs[:, None], xs + rs[:, None]
    jbox = jb.build(jb.BBox(jnp.asarray(lo), jnp.asarray(up)), jb.BBox)
    tbox = tb.build(tb.BBox(torch.as_tensor(lo), torch.as_tensor(up)),
                    tb.BBox)
    p = np.ones((3, 12), np.float32)
    wide = dict(tile=32, pair_cap=256)
    with pytest.raises(NotImplementedError):
        jpar.sharded_tile_pair(mesh, jbvh, jbox, 64, alg=JTile(**wide))
    with pytest.raises(NotImplementedError):
        ts._local_sharded_tile_pair(tbvh, tbox, 64, 0, N_DEV,
                                    alg=tb.TileTraversal(**wide))
    cases = [
        (lambda: jpar.sharded_self_contact(mesh, jbvh, 64),
         lambda: ts._local_sharded_self_contact(tbvh, 64, 0, N_DEV)),
        (lambda: jpar.sharded_rays(mesh, jbvh, p, p, 64),
         lambda: ts._local_sharded_rays(tbvh, p, p, 64, 0, N_DEV)),
        (lambda: jpar.sharded_rays(mesh, jbvh, p, p, 64, engine="walk"),
         lambda: ts._local_sharded_rays(tbvh, p, p, 64, 0, N_DEV,
                                        engine="walk")),
        (lambda: jpar.sharded_tile_self_contact(mesh, jbvh, 64,
                                                alg=JTile(**wide)),
         lambda: ts._local_sharded_tile_self_contact(
             tbvh, 64, 0, N_DEV, alg=tb.TileTraversal(**wide))),
        (lambda: jpar.sharded_tile_pair(mesh, jbvh, jbvh, 64,
                                        alg=JTile(**wide)),
         lambda: ts._local_sharded_tile_pair(
             tbvh, tbvh, 64, 0, N_DEV, alg=tb.TileTraversal(**wide))),
    ]
    for jax_call, port_call in cases:
        with pytest.raises(ValueError):
            jax_call()
        with pytest.raises(ValueError):
            port_call()


@pytest.mark.parametrize("P_cap", [8192, 1 << 16])
def test_phase1_superpairs_sp_round_matches_jax(P_cap):
    """``_phase1_superpairs`` with the sharded paths' ``sp_round`` (16 x 8
    ranks): the superpair list, its count and the overflow flag."""
    xs, rs = spheres(20000, 5, scale=27.0)
    jf = jtiles._tiled_fields(jax_bvh(xs, rs), 32, 4)
    tf = ttiles._tiled_fields(port_bvh(xs, rs), 32, 4)
    jsi, jsj, jn, jov = jtiles._phase1_superpairs(jf[2], jf[3], P_cap,
                                                  sp_round=16 * N_DEV)
    tsi, tsj, tn, tov = ttiles._phase1_superpairs(tf[2], P_cap,
                                                  sp_round=16 * N_DEV)
    assert tsi.shape[0] % (16 * N_DEV) == 0 and int(tn) > 0
    assert np.array_equal(np.asarray(jsi), tsi.numpy())
    assert np.array_equal(np.asarray(jsj), tsj.numpy())
    assert int(jn) == int(tn) and bool(jov) == bool(tov)


def test_public_names_and_arguments_are_jax():
    """The six names of the JAX package's ``parallel``, not re-exported at
    the top level, with its argument names and defaults (``make_mesh``
    takes a device type where the JAX package takes devices)."""
    assert tpar.__all__ == jpar.__all__
    assert not set(tpar.__all__) & set(tb.__all__)
    for name in tpar.__all__:
        jsig = inspect.signature(getattr(jpar, name)).parameters
        tsig = inspect.signature(getattr(tpar, name)).parameters
        if name == "make_mesh":
            assert (list(jsig), list(tsig)) == (["devices", "axis"],
                                                ["device_type", "axis"])
        else:
            assert list(jsig) == list(tsig), name
        for arg in list(jsig)[1:]:
            jd, td = jsig[arg].default, tsig[arg].default
            if arg == "node_kind":
                assert (jd.__name__, td.__name__) == ("BBox", "BBox")
            else:
                assert jd == td, (name, arg)
            assert jsig[arg].kind == tsig[arg].kind, (name, arg)


def test_make_mesh_raises_without_a_group_or_a_card():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_mesh()
