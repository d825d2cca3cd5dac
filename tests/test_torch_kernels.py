"""The port's three kernels against the JAX package's Pallas kernels.

Each scene runs through the port's traversal on the CPU while a recorder
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
}


def record_inputs(monkeypatch, name):
    """Run the port's traversal on the CPU and return the recorded kernel
    arguments ``{kernel: (args, kwargs)}``."""
    kind, n, seed, scale, params, capacity = SCENES[name]
    xs, rs = spheres(n, seed, scale)
    if kind == "sphere":
        vol = tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))
    else:
        vol = tb.BBox(torch.from_numpy(xs - rs[:, None]),
                      torch.from_numpy(xs + rs[:, None]))
    seen = {}
    for k in KERNELS:
        fn = getattr(ttiles, k)

        def rec(*args, _k=k, _fn=fn, **kw):
            seen[_k] = (args, kw)
            return _fn(*args, **kw)
        monkeypatch.setattr(ttiles, k, rec)
    tb.traverse_tiles_fixed(tb.build(vol), capacity,
                            alg=tb.TileTraversal(**params))
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
    want = jax_bits(tuple(j(sub[k]) for k in range(3)),
                    tuple(j(sub[k]) for k in range(3, 6)),
                    tuple(j(tiles[k]) for k in range(3)),
                    tuple(j(tiles[k]) for k in range(3, 6)),
                    j(si), j(sj), j(nsp), Ta=sub.shape[1], Tb=tiles.shape[1],
                    triangle=kw["triangle"], n_bands=sub.shape[2],
                    interpret=True)[:, :, :32]
    got = ops.subtile_band_bits_plain(sub, tiles, si, sj, nsp, **kw)
    assert int((got != 0).sum()) > 0
    assert np.array_equal(np.asarray(want), got.numpy())


def test_run_counts_plain_matches_pallas(scene):
    _, seen = scene
    (a_idx, run_idx, bm, nsteps, fields), kw = seen["tile_run_counts"]
    G = fields.shape[2]
    W = run_idx.shape[0] // a_idx.shape[0]
    want_c, want_m = jax_counts(
        j(a_idx), j(run_idx), tuple(j(w) for w in bm), j(nsteps),
        tuple(j(f) for f in fields), mask_kind=kw["mask_kind"], G=G, W=W,
        R=kw["R"], NB=kw["NB"], dedup=kw["dedup"], interpret=True,
        with_colmax=True)
    got_c, got_m = ops.tile_run_counts_plain(a_idx, run_idx, bm, nsteps,
                                             fields, **kw)
    assert int(got_c.sum()) > 0
    assert np.array_equal(np.asarray(want_c), got_c.numpy())
    assert np.array_equal(np.asarray(want_m), got_m.numpy())


def test_group_emit_plain_matches_pallas(scene):
    name, seen = scene
    (a_idx, b_idx, nsteps, fields), kw = seen["tile_group_emit"]
    W = b_idx.shape[0] // a_idx.shape[0]
    gi, gj, total, flags = jax_emit(
        j(a_idx), j(b_idx), j(nsteps), tuple(j(f) for f in fields),
        mask_kind=kw["mask_kind"], G=fields.shape[2], W=W,
        ROW_CAP=kw["ROW_CAP"], CAP_PAIR=kw["CAP_PAIR"], dedup=kw["dedup"],
        CAP=kw["CAP"], interpret=True)
    tgi, tgj, ttotal, tflags = ops.tile_group_emit_plain(
        a_idx, b_idx, nsteps, fields, **kw)
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
