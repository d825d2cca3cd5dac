"""The port's three kernels against the JAX package's Pallas kernels.

Each scene (one BVH, or two for the ``pair_*`` scenes: ``triangle=False``
in the band bits, ``dedup=False`` on two field sets in the count and emit
kernels) runs through the port's traversal on the CPU while a recorder
keeps the arguments of the three kernel wrappers (there they take their
plain PyTorch versions).  The same arguments, as numpy arrays, then go to
``subtile_band_bits``, ``tile_run_counts(with_colmax=True)`` and
``tile_group_emit`` of the JAX package, run in interpret mode as its own
tests run them on the CPU.  Every comparison is exact: the predicates are
comparisons of identically rounded float32 values and every output is an
integer (bits; counts and column maxima; the emitted contacts as a sorted
set, with the total and the overflow flags).

On a machine with a card, ``test_kernel_matches_plain_on_card`` (marker
``gpu``) builds the CUDA kernels and holds each against its plain version on
the same inputs; it skips without a card.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    from implicitbvh_tpu.ops.subtile import subtile_band_bits as jax_bits
    from implicitbvh_tpu.ops.tile_contact import tile_group_emit as jax_emit
    from implicitbvh_tpu.ops.tile_contact import \
        tile_run_counts as jax_counts
except ImportError:
    jnp = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch.traverse import tiles as ttiles

KERNELS = ("subtile_band_bits", "tile_run_counts", "tile_group_emit")


def spheres(n, seed, scale):
    rng = np.random.default_rng(seed)
    xs = (rng.random((n, 3)) * scale).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    return xs, rs


# (leaf kind, leaves, seed, scale, traversal parameters, capacity); the
# JAX kernels' interpret-mode compile time grows with count_w and bands,
# so the scenes past the first run two run slots per count step
SCENES = {
    "sphere": ("sphere", 2048, 0, 11.0, dict(tile=32), 4096),
    "box": ("box", 1500, 1, 14.0, dict(tile=32, count_w=2), 4096),
    "sphere_nb8": ("sphere", 1200, 2, 9.0,
                   dict(tile=32, bands=8, count_w=2), 4096),
    # a dense cluster: rows over row_cap and more contacts than capacity
    "dense": ("sphere", 160, 5, 1.2,
              dict(tile=32, row_cap=2, pair_cap=128, count_w=2), 1024),
    # two BVHs (the second of PAIR_LEAVES leaves, seed + 1): T1 = 24 tiles
    # against T2 = 40, one supertile against two
    "pair_sphere": ("sphere", 760, 21, 9.0,
                    dict(tile=32, row_cap=16, count_w=2, emit_w=2), 4096),
    "pair_box_nb16": ("box", 760, 23, 9.0,
                      dict(tile=32, row_cap=16, pair_cap=128, bands=16,
                           count_w=2, emit_w=2), 4096),
}
PAIR_LEAVES = 1270


def record_inputs(monkeypatch, name):
    """Run the port's traversal on the CPU and return the recorded kernel
    arguments ``{kernel: (args, kwargs)}``."""
    kind, n, seed, scale, params, capacity = SCENES[name]
    def volume(n, seed):
        xs, rs = spheres(n, seed, scale)
        if kind == "sphere":
            return tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))
        return tb.BBox(torch.from_numpy(xs - rs[:, None]),
                       torch.from_numpy(xs + rs[:, None]))

    seen = {}
    for k in KERNELS:
        fn = getattr(ttiles, k)

        def rec(*args, _k=k, _fn=fn, **kw):
            seen[_k] = (args, kw)
            return _fn(*args, **kw)
        monkeypatch.setattr(ttiles, k, rec)
    alg = tb.TileTraversal(**params)
    if name.startswith("pair"):
        out = tb.traverse_tiles_pair_fixed(
            tb.build(volume(n, seed)), tb.build(volume(PAIR_LEAVES, seed + 1)),
            capacity, alg=alg)
    else:
        out = tb.traverse_tiles_fixed(tb.build(volume(n, seed)), capacity,
                                      alg=alg)
    assert int(out[0]) > 0
    monkeypatch.undo()
    return seen


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    with pytest.MonkeyPatch.context() as mp:
        return request.param, record_inputs(mp, request.param)


def j(t):
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    return jnp.asarray(t.numpy())


def emitted(gi, gj, total):
    n = min(int(total), gi.shape[0])
    return sorted(zip(np.asarray(gi[:n]).astype(np.int64).tolist(),
                      np.asarray(gj[:n]).astype(np.int64).tolist()))


def test_band_bits_plain_matches_pallas(scene):
    _, seen = scene
    (sub, tiles, si, sj, nsp), kw = seen["subtile_band_bits"]
    want = jax_band_bits(sub, tiles, si, sj, nsp, kw["triangle"])
    got = ops.subtile_band_bits_plain(sub, tiles, si, sj, nsp, **kw)
    assert int((got != 0).sum()) > 0
    assert np.array_equal(np.asarray(want), got.numpy())


def jax_band_bits(sub, tiles, si, sj, nsp, triangle):
    return jax_bits(tuple(j(sub[k]) for k in range(3)),
                    tuple(j(sub[k]) for k in range(3, 6)),
                    tuple(j(tiles[k]) for k in range(3)),
                    tuple(j(tiles[k]) for k in range(3, 6)),
                    j(si), j(sj), j(nsp), Ta=sub.shape[1], Tb=tiles.shape[1],
                    triangle=triangle, n_bands=sub.shape[2],
                    interpret=True)[:, :, :32]


@pytest.mark.parametrize("name", ["pair_sphere", "pair_box_nb16"])
def test_band_bits_full_grid_nsp_below_at_and_above_cap(name):
    """``triangle=False`` with Ta != Tb (NB = 4 and 16): every slot given
    a superpair, and ``nsp`` below, at and above ``SP_cap`` (phase 1 of the
    fallback hands it over unclamped): the slots below ``nsp`` are filled,
    the others zero, none past ``SP_cap`` exists."""
    with pytest.MonkeyPatch.context() as mp:
        (sub, tiles, si, sj, _), kw = \
            record_inputs(mp, name)["subtile_band_bits"]
    assert kw["triangle"] is False and sub.shape[1] != tiles.shape[1]
    SP_cap = si.shape[0]
    slot = torch.arange(SP_cap, dtype=torch.int32)
    si, sj = torch.zeros_like(si), slot % 2     # S1 = 1, S2 = 2 supertiles
    full = None
    for n in (3, SP_cap, SP_cap + 5):
        nsp = torch.tensor([n], dtype=torch.int32)
        want = np.asarray(jax_band_bits(sub, tiles, si, sj, nsp, False))
        got = ops.subtile_band_bits_plain(sub, tiles, si, sj, nsp,
                                          triangle=False)
        assert got.shape == (SP_cap, 32, 32)
        assert np.array_equal(want, got.numpy())
        assert int((got[:min(n, SP_cap)] != 0).sum()) > 0
        assert not got[n:].any()
        if n >= SP_cap:
            full = got if full is None else full
            assert torch.equal(got, full)
    # rows and columns of the grid are different tiles: not symmetric
    assert not torch.equal(full[0], full[0].T)


def test_run_counts_plain_matches_pallas(scene):
    name, seen = scene
    (a_idx, run_idx, bm, nsteps, *fields), kw = seen["tile_run_counts"]
    assert (len(fields), kw["dedup"]) == \
        ((2, False) if name.startswith("pair") else (1, True))
    G = fields[0].shape[2]
    W = run_idx.shape[0] // a_idx.shape[0]
    want_c, want_m = jax_counts(
        j(a_idx), j(run_idx), tuple(j(w) for w in bm), j(nsteps),
        *[tuple(j(f) for f in fs) for fs in fields],
        mask_kind=kw["mask_kind"], G=G, W=W,
        R=kw["R"], NB=kw["NB"], dedup=kw["dedup"], interpret=True,
        with_colmax=True)
    got_c, got_m = ops.tile_run_counts_plain(a_idx, run_idx, bm, nsteps,
                                             *fields, **kw)
    assert int(got_c.sum()) > 0
    assert np.array_equal(np.asarray(want_c), got_c.numpy())
    assert np.array_equal(np.asarray(want_m), got_m.numpy())


def test_group_emit_plain_matches_pallas(scene):
    name, seen = scene
    (a_idx, b_idx, nsteps, *fields), kw = seen["tile_group_emit"]
    W = b_idx.shape[0] // a_idx.shape[0]
    gi, gj, total, flags = jax_emit(
        j(a_idx), j(b_idx), j(nsteps),
        *[tuple(j(f) for f in fs) for fs in fields],
        mask_kind=kw["mask_kind"], G=fields[0].shape[2], W=W,
        ROW_CAP=kw["ROW_CAP"], CAP_PAIR=kw["CAP_PAIR"], dedup=kw["dedup"],
        CAP=kw["CAP"], interpret=True)
    tgi, tgj, ttotal, tflags = ops.tile_group_emit_plain(
        a_idx, b_idx, nsteps, *fields, **kw)
    assert int(total) == int(ttotal) > 0
    assert int(flags) == int(tflags) == (3 if name == "dense" else 0)
    if name != "dense":
        # with an overflow bit set the stream's contents differ by design
        # (the wrapper grows and re-runs), so only the total and the flags
        # are compared there
        assert emitted(gi, gj, total) == emitted(tgi, tgj, ttotal)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(scene):
    """Each CUDA kernel equals its plain version on the scene's inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    _, seen = scene
    plain = {"subtile_band_bits": ops.subtile_band_bits_plain,
             "tile_run_counts": ops.tile_run_counts_plain,
             "tile_group_emit": ops.tile_group_emit_plain}
    for k in KERNELS:
        args, kw = seen[k]
        args = tuple(a.cuda() for a in args)
        got, want = getattr(ops, k)(*args, **kw), plain[k](*args, **kw)
        if k == "tile_group_emit":
            assert emitted(got[0].cpu(), got[1].cpu(), got[2]) == \
                emitted(want[0].cpu(), want[1].cpu(), want[2])
            got, want = got[2:], want[2:]
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), k
