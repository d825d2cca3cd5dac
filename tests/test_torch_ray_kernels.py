"""The ray variants of the tile-contact kernels, the moment decode and
phase 1's band bits (R1), against the JAX package.

Each scene runs through the port's tile ray traversal on the CPU while a
recorder keeps the kernel wrappers' arguments (there they take their plain
PyTorch versions): the count kernel with ``moments=True`` on the two-phase
route with the moment decode, the emit kernel on the two-phase route
without it, the slot kernel on the fallback.  The same arguments, as numpy
arrays, go to the JAX package's Pallas kernels in interpret mode and to its
``_moment_decode``.  Every comparison is exact: the predicates compare
identically rounded float32 values and every output is an integer (counts,
column maxima and the whole word plane; the emitted stream as a sorted set
with its total and flags; the slot lanes below each pair's count).

R1 (``ops.ray_band_bits``) has no Pallas counterpart: its plain version is
held against the JAX package's ``_ray_tile_hits`` (jnp) on the port's own
ray and leaf tiles, in float32 and float64.

``gpu``-marked tests hold each CUDA variant against its plain version on the
same inputs; they skip without a card.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.ops.tile_contact import _seg
    from implicitbvh_tpu.ops.tile_contact import \
        tile_group_contacts as jax_group_contacts
    from implicitbvh_tpu.ops.tile_contact import tile_group_emit as jax_emit
    from implicitbvh_tpu.ops.tile_contact import \
        tile_pair_contacts as jax_pair_contacts
    from implicitbvh_tpu.ops.tile_contact import \
        tile_run_counts as jax_counts
    from implicitbvh_tpu.traverse.ray_tiles import \
        _ray_tile_hits as jax_ray_tile_hits
    from implicitbvh_tpu.traverse.tiles import \
        _moment_decode as jax_moment_decode
except ImportError:
    jnp = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch import volumes as tvol
from implicitbvh_tpu_torch.traverse import ray_tiles as tray
from implicitbvh_tpu_torch.traverse import tiles as ttiles

CPU = torch.device("cpu")
RECORDED = ("tile_run_counts", "tile_group_emit", "tile_group_contacts",
            "_moment_decode")
TWO_PHASE = dict(tile=32, row_cap=16, pair_cap=128, count_w=2, emit_w=2)
FALLBACK = dict(tile=32, row_cap=16, pair_cap=256, count_w=2)


def ray_scene(kind):
    """Leaves of ``kind`` and rays: random ones, some with zero direction
    components, and a bundle of near-parallel rays from one corner, so that
    several rays of a tile hit the same leaf (columns with 2 and more
    hits)."""
    rng = np.random.default_rng(21 if kind == "sphere" else 22)
    n, nrays = 400, 160
    xs = (rng.random((n, 3)) * 8).astype(np.float32)
    rs = (rng.random(n) * 0.3 + 0.05).astype(np.float32)
    p = (rng.random((3, nrays)) * 8).astype(np.float32)
    d = (rng.random((3, nrays)) - 0.5).astype(np.float32)
    d[0, :8] = 0.0
    d[1, 4:12] = 0.0
    p[:, 64:] = (rng.random((3, nrays - 64)) * 1.2).astype(np.float32)
    d[:, 64:] = 1.0 + (rng.random((3, nrays - 64)) * 0.3).astype(np.float32)
    vol = (tb.BSphere(xs, rs, device=CPU) if kind == "sphere" else
           tb.BBox(xs - rs[:, None], xs + rs[:, None], device=CPU))
    return tb.build(vol), p, d


def record(run, module):
    """``{name: (args, kwargs)}`` of the recorded wrappers' last calls
    during ``run()``."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in RECORDED:
            fn = getattr(module, k, None)
            if fn is None:
                continue

            def rec(*args, _k=k, _fn=fn, **kw):
                seen[_k] = (args, kw)
                return _fn(*args, **kw)
            mp.setattr(module, k, rec)
        run()
    return seen


@pytest.fixture(scope="module", params=["sphere", "box"])
def scene(request):
    """Recorded inputs of one ray scene: B2 with moments and the decode
    (two-phase, decode_k 8), B3 (two-phase, decode_k 0), B4 (fallback)."""
    bvh, p, d = ray_scene(request.param)

    def fixed(params, capacity=1024):
        out = tb.traverse_rays_tiles_fixed(
            bvh, p, d, capacity, alg=tb.TileTraversal(**params))
        assert int(out[2]) == 0 and int(out[0]) > 0

    dec = record(lambda: fixed(dict(TWO_PHASE, decode_k=8)), ttiles)
    emit = record(lambda: fixed(TWO_PHASE), ttiles)
    slots = record(lambda: fixed(FALLBACK), ttiles)
    assert "tile_group_emit" in emit and "_moment_decode" not in emit
    return {"kind": "ray_" + request.param,
            "tile_run_counts": dec["tile_run_counts"],
            "_moment_decode": dec["_moment_decode"],
            "tile_group_emit": emit["tile_group_emit"],
            "tile_group_contacts": slots["tile_group_contacts"]}


def j(t):
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    return jnp.asarray(t.numpy())


def jf(fields):
    return tuple(j(f) for f in fields)


def emitted(gi, gj, total):
    n = min(int(total), gi.shape[0])
    return sorted(zip(np.asarray(gi[:n]).astype(np.int64).tolist(),
                      np.asarray(gj[:n]).astype(np.int64).tolist()))


def assert_slots_equal(gi, gj, counts, want_gi, want_gj, CAP_PAIR):
    """Without overflow every lane below a pair's count is filled and must
    hold the reference's positions."""
    below = np.arange(CAP_PAIR)[None, :] < \
        np.minimum(counts.numpy(), CAP_PAIR)[:, None]
    assert np.array_equal(np.asarray(want_gi)[below], gi.numpy()[below])
    assert np.array_equal(np.asarray(want_gj)[below], gj.numpy()[below])
    return int(below.sum())


def test_run_counts_moments_plain_matches_pallas(scene):
    """B2 with a ray mask, two field sets and moments: counts, colmax and
    the whole word plane."""
    (a_idx, run_idx, bm, nsteps, rf, lf), kw = scene["tile_run_counts"]
    assert kw["mask_kind"] == scene["kind"] and kw["moments"] and \
        not kw["dedup"]
    W = run_idx.shape[0] // a_idx.shape[0]
    want = jax_counts(
        j(a_idx), j(run_idx), tuple(j(w) for w in bm), j(nsteps), jf(rf),
        jf(lf), mask_kind=kw["mask_kind"], G=rf.shape[2], W=W, R=kw["R"],
        NB=kw["NB"], dedup=False, interpret=True, moments=True)
    got = ops.tile_run_counts_plain(a_idx, run_idx, bm, nsteps, rf, lf, **kw)
    assert int(got[0].sum()) > 0
    cc = got[2] >> 23          # columns with 1, 2 and more hits
    assert all(bool(m.any()) for m in (cc == 1, cc == 2, cc > 2))
    for w, g in zip(want, got, strict=True):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert tuple(got[2].shape) == (run_idx.shape[0] * kw["R"], 128)
    assert not bool(got[2][:, rf.shape[2]:].any())
    # without moments: the same counts and column maxima
    c, m = ops.tile_run_counts_plain(a_idx, run_idx, bm, nsteps, rf, lf,
                                     **dict(kw, moments=False))
    assert torch.equal(c, got[0]) and torch.equal(m, got[1])


def test_group_emit_plain_matches_pallas(scene):
    """B3 with a ray mask and two field sets."""
    (a_idx, b_idx, nsteps, rf, lf), kw = scene["tile_group_emit"]
    assert kw["mask_kind"] == scene["kind"] and not kw["dedup"]
    W = b_idx.shape[0] // a_idx.shape[0]
    gi, gj, total, flags = jax_emit(
        j(a_idx), j(b_idx), j(nsteps), jf(rf), jf(lf),
        mask_kind=kw["mask_kind"], G=rf.shape[2], W=W, ROW_CAP=kw["ROW_CAP"],
        CAP_PAIR=kw["CAP_PAIR"], dedup=False, CAP=kw["CAP"], interpret=True)
    tgi, tgj, ttotal, tflags = ops.tile_group_emit_plain(
        a_idx, b_idx, nsteps, rf, lf, **kw)
    assert int(total) == int(ttotal) > 0
    assert int(flags) == int(tflags) == 0
    assert emitted(gi, gj, total) == emitted(tgi, tgj, ttotal)


def test_group_contacts_plain_matches_pallas(scene):
    """B4 with a ray mask and two field sets: counts, overflow, lanes."""
    (a_idx, b_idx, nsteps, rf, lf), kw = scene["tile_group_contacts"]
    assert kw["mask_kind"] == scene["kind"] and not kw["dedup"]
    C = kw["CAP_PAIR"]
    slots, counts, over = jax_group_contacts(
        j(a_idx), j(b_idx), j(nsteps), jf(rf), jf(lf),
        mask_kind=kw["mask_kind"], G=rf.shape[2],
        W=b_idx.shape[0] // a_idx.shape[0], ROW_CAP=kw["ROW_CAP"],
        CAP_PAIR=C, dedup=False, interpret=True)
    gi, gj, got_c, got_o = ops.tile_group_contacts_plain(
        a_idx, b_idx, nsteps, rf, lf, **kw)
    assert np.array_equal(np.asarray(counts), got_c.numpy())
    assert bool(over) == bool(got_o) is False
    seg = _seg(C)
    slots = np.asarray(slots)
    assert assert_slots_equal(gi, gj, got_c, slots[:, :C],
                              slots[:, seg:seg + C], C) > 0


def packed_pairs(a_idx, b_idx, nsteps):
    """The live entries of a grouped list as a packed ``ti << 16 | tj``
    pair list (padded to a multiple of 8) and its length."""
    W = b_idx.shape[0] // a_idx.shape[0]
    e = torch.arange(b_idx.shape[0])
    live = ((e // W) < nsteps) & ((b_idx >> 16) != 0)
    packed = ((a_idx[e // W] << 16) | (b_idx & 0xFFFF))[live]
    n = packed.shape[0]
    packed = torch.nn.functional.pad(packed, (0, -n % 8)).int().contiguous()
    return packed, torch.tensor([n], dtype=torch.int32)


def test_pair_contacts_plain_matches_pallas(scene):
    """B6 shares B4's source, so it takes the ray masks too: the packed
    pair list of the scene's live entries, every band live."""
    (a_idx, b_idx, nsteps, rf, lf), kw = scene["tile_group_contacts"]
    packed, npairs = packed_pairs(a_idx, b_idx, nsteps)
    C = kw["CAP_PAIR"]
    slots, counts, over = jax_pair_contacts(
        j(packed), j(npairs), jf(rf), jf(lf), mask_kind=kw["mask_kind"],
        G=rf.shape[2], ROW_CAP=kw["ROW_CAP"], CAP_PAIR=C, dedup=False,
        interpret=True, batch=8)
    gi, gj, got_c, got_o = ops.tile_pair_contacts_plain(
        packed, npairs, rf, lf, **kw)
    assert np.array_equal(np.asarray(counts), got_c.numpy())
    assert bool(over) == bool(got_o) is False
    seg = _seg(C)
    slots = np.asarray(slots)
    assert assert_slots_equal(gi, gj, got_c, slots[:, :C],
                              slots[:, seg:seg + C], C) > 0


def test_moment_decode_matches_jax(scene):
    """The decoded stream as a set, and its total."""
    (words, dec_pk, dec_flat, dec_cnt, ndec, G, K, capacity), _ = \
        scene["_moment_decode"]
    assert int(ndec) > 0
    gi, gj, total = jax_moment_decode(j(words), j(dec_pk), j(dec_flat),
                                      j(dec_cnt), j(ndec), G, K, capacity)
    tgi, tgj, ttotal = ttiles._moment_decode(words, dec_pk, dec_flat,
                                             dec_cnt, ndec, G, K, capacity)
    assert int(total) == int(ttotal) >= int(ndec)
    assert emitted(gi, gj, total) == emitted(tgi, tgj, ttotal)
    assert len(set(emitted(tgi, tgj, ttotal))) == int(ttotal)


def test_run_counts_moments_self_contact_matches_pallas():
    """B2 with moments on one field set with the dedup triangle (tile
    self-contact with decode_k > 0)."""
    rng = np.random.default_rng(0)
    xs = (rng.random((1200, 3)) * 9.0).astype(np.float32)
    rs = (rng.random(1200) * 0.4 + 0.05).astype(np.float32)
    bvh = tb.build(tb.BSphere(xs, rs, device=CPU))
    seen = record(lambda: tb.traverse_tiles_fixed(
        bvh, 4096, alg=tb.TileTraversal(tile=32, count_w=2, decode_k=8)),
        ttiles)
    (a_idx, run_idx, bm, nsteps, fields), kw = seen["tile_run_counts"]
    assert kw["moments"] and kw["dedup"]
    want = jax_counts(
        j(a_idx), j(run_idx), tuple(j(w) for w in bm), j(nsteps), jf(fields),
        mask_kind="sphere", G=32, W=2, R=kw["R"], NB=kw["NB"], dedup=True,
        interpret=True, moments=True)
    got = ops.tile_run_counts_plain(a_idx, run_idx, bm, nsteps, fields, **kw)
    assert int(got[0].sum()) > 0
    for w, g in zip(want, got, strict=True):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_decode_square_root_is_exact_for_every_row_pair():
    """A column with two hits at rows i1 <= i2 carries is = i1 + i2 and
    iq = i1^2 + i2^2; the decode's float32 root of 2 iq - is^2 must give
    |i1 - i2| for every pair of rows 0..127."""
    i = torch.arange(128, dtype=torch.int32)
    i1, i2 = torch.meshgrid(i, i, indexing="ij")
    isv, iq = i1 + i2, i1 * i1 + i2 * i2
    assert int(iq.max()) < 1 << 15 and int(isv.max()) < 1 << 8
    dv = torch.sqrt((2 * iq - isv * isv).clamp(min=0).float()).int()
    assert torch.equal(dv, (i1 - i2).abs())
    assert torch.equal((isv - dv) >> 1, torch.minimum(i1, i2))
    assert torch.equal((isv + dv) >> 1, torch.maximum(i1, i2))
    # and through the decode itself: one pair, one column per (i1, i2)
    sel = i1 < i2
    a, b = i1[sel][:128 * 8], i2[sel][:128 * 8]
    words = ((2 << 23) | ((a + b) << 15) | (a * a + b * b)).view(8, 128)
    gi, gj, total = ttiles._moment_decode(
        words, torch.arange(8, dtype=torch.int32) << 16,
        torch.arange(8, dtype=torch.int32),
        torch.full((8,), 256, dtype=torch.int32),
        torch.tensor(8, dtype=torch.int32), 128, 128, 4096)
    assert int(total) == 2048
    want = sorted((t * 128 + r, c) for t in range(8) for c in range(128)
                  for r in (int(a[t * 128 + c]), int(b[t * 128 + c])))
    assert emitted(gi, gj, total) == want


def test_reciprocal_matches_jax_bit_for_bit():
    """``1 / d`` of the slab test is an IEEE division in both packages."""
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    rng = np.random.default_rng(5)
    d = np.concatenate([rng.standard_normal(1 << 16),
                        (rng.random(1 << 16) - 0.5) * 1e-30,
                        [0.0, -0.0, np.inf, -np.inf, np.nan]]
                       ).astype(np.float32)
    want = np.asarray(jnp.float32(1.0) / jnp.asarray(d))
    got = tvol._reciprocal(torch.from_numpy(d)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_isintersection_matches_jax(kind):
    """The ray predicate against the JAX package's, with NaN volumes and
    rays, zero direction components and rays in face planes."""
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    rng = np.random.default_rng(6)
    n, k = 300, 200
    xs = (rng.random((n, 3)) * 4).astype(np.float32)
    rs = (rng.random(n) * 0.5 + 0.05).astype(np.float32)
    xs[:40] = np.round(xs[:40])
    rs[:40] = 0.5
    xs[5] = np.nan
    p = (rng.random((3, k)) * 6 - 1).astype(np.float32)
    d = (rng.random((3, k)) - 0.5).astype(np.float32)
    p[:, :60] = np.round(p[:, :60]) + 0.5      # origins on face planes
    d[0, :30] = 0.0
    d[1, 20:50] = 0.0
    d[2, 40:60] = 0.0
    p[0, 7] = np.nan
    d[1, 9] = np.nan
    if kind == "sphere":
        jv = jb.BSphere(jnp.asarray(xs)[:, None, :], jnp.asarray(rs)[:, None])
        tv = tb.BSphere(xs[:, None, :], rs[:, None], device=CPU)
    else:
        lo, up = xs - rs[:, None], xs + rs[:, None]
        jv = jb.BBox(jnp.asarray(lo)[:, None, :], jnp.asarray(up)[:, None, :])
        tv = tb.BBox(lo[:, None, :], up[:, None, :], device=CPU)
    want = np.asarray(jb.volumes.isintersection(
        jv, tuple(jnp.asarray(p[c])[None, :] for c in range(3)),
        tuple(jnp.asarray(d[c])[None, :] for c in range(3))))
    got = tb.isintersection(tv, tuple(torch.from_numpy(p[c])[None, :]
                                      for c in range(3)),
                            tuple(torch.from_numpy(d[c])[None, :]
                                  for c in range(3)))
    assert want.shape == (n, k) and np.array_equal(want, got.numpy())
    assert 0 < int(got.sum()) < n * k
    assert not bool(got[5].any())
    if kind == "sphere":
        assert not bool(got[:, 7].any())
    else:
        # a NaN origin coordinate only drops that axis' slab: the select
        # min/max passes the other operand on
        assert bool(got[:, 7].any())
        # the select min/max is not torch.minimum/maximum: with those the
        # answer differs on this input
        inv = [tvol._reciprocal(torch.from_numpy(d[c])[None, :])
               for c in range(3)]
        tmin = tmax = None
        for c in range(3):
            t1 = (tv.los[c] - torch.from_numpy(p[c])[None, :]) * inv[c]
            t2 = (tv.ups[c] - torch.from_numpy(p[c])[None, :]) * inv[c]
            lo_c, hi_c = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = lo_c if tmin is None else torch.maximum(tmin, lo_c)
            tmax = hi_c if tmax is None else torch.minimum(tmax, hi_c)
        assert not torch.equal((tmin <= tmax) & (tmax >= 0), got)


def test_wrapper_checks():
    """What the wrappers refuse: moments on tiles over 128, dedup with two
    field sets, field counts that do not fit the mask."""
    rf = torch.zeros((6, 2, 32))
    lf = torch.zeros((4, 3, 32))
    a_idx = torch.zeros(256, dtype=torch.int32)
    run_idx = torch.zeros(512, dtype=torch.int32)
    bm = torch.zeros((1, 512), dtype=torch.int32)
    ns = torch.zeros(1, dtype=torch.int32)
    c, m, w = ops.tile_run_counts(a_idx, run_idx, bm, ns, rf, lf,
                                  mask_kind="ray_sphere", moments=True)
    assert tuple(w.shape) == (512 * 8, 128) and not bool(w.any())
    with pytest.raises(ValueError, match="dedup"):
        ops.tile_run_counts(a_idx, run_idx, bm, ns, rf, lf,
                            mask_kind="ray_sphere", dedup=True)
    with pytest.raises(ValueError, match="ray_box"):
        ops.tile_run_counts(a_idx, run_idx, bm, ns, rf, lf,
                            mask_kind="ray_box")
    with pytest.raises(ValueError, match="mask_kind"):
        ops.tile_group_emit(a_idx, run_idx, ns, rf, lf, mask_kind="ray")
    big = torch.zeros((4, 2, 256))
    with pytest.raises(ValueError, match="moments"):
        ops.tile_run_counts(a_idx, run_idx, bm, ns, big, mask_kind="sphere",
                            moments=True)
    with pytest.raises(ValueError, match="dedup"):
        ops.tile_group_contacts(a_idx, run_idx, ns, rf, lf,
                                mask_kind="ray_sphere", dedup=True)


def _cuda(args):
    return tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.gpu
def test_ray_kernels_match_plain_on_card(scene):
    """B2 (moments), B3, B4 and B6 with a ray mask on the card equal their
    plain versions, and so does the decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    args, kw = scene["tile_run_counts"]
    args = _cuda(args)
    (c, m, words), (pc, pm, pwords) = (
        ops.tile_run_counts(*args, **kw),
        ops.tile_run_counts_plain(*args, **kw))
    live = ops.run_live_pairs(args[1], args[2], args[3], args[0].shape[0],
                              args[-1].shape[1], R=kw["R"], NB=kw["NB"])
    assert torch.equal(c, pc) and torch.equal(m, pm)
    # the card writes only the word rows of live pairs
    assert torch.equal(words[live], pwords[live])
    args, kw = scene["tile_group_emit"]
    args = _cuda(args)
    got = ops.tile_group_emit(*args, **kw)
    want = ops.tile_group_emit_plain(*args, **kw)
    assert emitted(got[0].cpu(), got[1].cpu(), got[2]) == \
        emitted(want[0].cpu(), want[1].cpu(), want[2])
    assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
    args, kw = scene["tile_group_contacts"]
    C = kw["CAP_PAIR"]
    packed, npairs = packed_pairs(*args[:3])
    for fn, plain, a in (
            (ops.tile_group_contacts, ops.tile_group_contacts_plain,
             _cuda(args)),
            (ops.tile_pair_contacts, ops.tile_pair_contacts_plain,
             _cuda((packed, npairs) + args[3:]))):
        gi, gj, c, o = fn(*a, **kw)
        pgi, pgj, pc, po = plain(*a, **kw)
        below = torch.arange(C, device="cuda")[None, :] < \
            pc.clamp(max=C)[:, None]
        assert torch.equal(c, pc) and bool(o) == bool(po)
        assert torch.equal(gi[below], pgi[below])
        assert torch.equal(gj[below], pgj[below])
    args, _ = scene["_moment_decode"]
    got = ttiles._moment_decode(*_cuda(args))
    want = ttiles._moment_decode(*args)
    assert emitted(got[0].cpu(), got[1].cpu(), got[2]) == \
        emitted(want[0], want[1], want[2])


# ---------------------------------------------------------------------------
# R1: phase 1's band bits


def ray_tiles_of(bvh, p, d, G, dtype=torch.float32):
    """Phase 1's inputs for ``bvh`` and the rays ``p``/``d``: the sorted,
    NaN-padded (6, RT, G) ray tiles and the (6, T) leaf-tile bounds."""
    tp, td = (tuple(torch.from_numpy(x[k]).to(dtype) for k in range(3))
              for x in (p, d))
    rf, _ = tray._ray_tile_fields(tp, td, tray._sort_rays(tp, td), G)
    return rf, ttiles._tiled_fields(bvh, G)[2].to(dtype)


@pytest.mark.parametrize("G,NB,dtype", [
    (32, 4, torch.float32), (32, 16, torch.float32),
    (128, 8, torch.float32), (64, 4, torch.float64)])
@pytest.mark.parametrize("kind", ["sphere", "box", "sparse"])
def test_ray_band_bits_plain_matches_jax(kind, G, NB, dtype):
    """R1's plain version, and the wrapper on CPU tensors, against the JAX
    package's ``_ray_tile_hits`` on the same tiles, bit for bit: the ray
    scenes above (zero direction components; their 160 rays leave a NaN
    tail at tiles 64 and 128) and a sparser one (4,000 spheres in a cube of
    side 60, 333 near-parallel rays: words with some bands dead, and below
    tile 128 words of 0)."""
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    if kind == "sparse":
        rng = np.random.default_rng(23)
        xs = (rng.random((4000, 3)) * 60).astype(np.float32)
        rs = (rng.random(4000) * 0.3 + 0.05).astype(np.float32)
        bvh = tb.build(tb.BSphere(xs, rs, device=CPU))
        p = np.stack([rng.random(333) * 60, rng.random(333) * 60,
                      np.full(333, -1.0)]).astype(np.float32)
        d = np.stack([(rng.random(333) - 0.5) * 0.2,
                      (rng.random(333) - 0.5) * 0.2,
                      np.ones(333)]).astype(np.float32)
    else:
        bvh, p, d = ray_scene(kind)
    rf, tl = ray_tiles_of(bvh, p, d, G, dtype)
    assert bool(torch.isnan(rf).any()) == bool(p.shape[1] % G)
    want = np.asarray(jax_ray_tile_hits(
        tuple(j(f) for f in rf), tuple(j(tl[k]) for k in range(3)),
        tuple(j(tl[k]) for k in range(3, 6)), NB))
    got = ops.ray_band_bits_plain(rf, tl, NB)
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    assert torch.equal(ops.ray_band_bits(rf, tl, NB), got)
    assert torch.equal(tray._ray_tile_hits(rf, tl, NB), got)
    assert bool(got.any()) and int(got.max()) < 1 << NB
    if kind == "sparse":
        assert bool((got == 0).any()) or G == 128
        assert bool(((got > 0) & (got < (1 << NB) - 1)).any())


def edge_band_inputs(G, dtype, device="cpu", seed=0):
    """R1's edge cases at tile size ``G``: 3 G + 17 rays (a NaN tail in the
    last ray tile); ray tile 0 far outside, pointing away (no hit); zero
    direction components; origins on the lattice planes that carry a third
    of the boxes' faces, with a zero component along that axis (0 * inf =
    NaN in the slab test).  Returns ``(rfields, tiles)``."""
    rng = np.random.default_rng(seed)
    T = 300
    lo = rng.random((3, T)) * 8
    up = lo + rng.random((3, T)) * 1.5 + 0.05
    lo[:, :T // 3] = np.floor(lo[:, :T // 3])
    up[:, :T // 3] = lo[:, :T // 3] + 1
    n = 3 * G + 17
    p = rng.random((3, n)) * 9 - 0.5
    d = rng.random((3, n)) - 0.5
    p[:, :G], d[:, :G] = -100.0, -1.0
    for k in range(3):
        sel = rng.random(n) < 0.15
        sel[:G] = False
        d[k, sel] = 0.0
        face = rng.random(n) < 0.15
        face[:G] = False
        p[k, face] = np.round(p[k, face])
        d[k, face] = 0.0
    tp, td = (tuple(torch.tensor(x[k], dtype=dtype, device=device)
                    for k in range(3)) for x in (p, d))
    rf, _ = tray._ray_tile_fields(tp, td, torch.arange(n, device=device), G)
    tiles = torch.tensor(np.concatenate([lo, up]), dtype=dtype, device=device)
    return rf, tiles


def test_ray_band_bits_edge_inputs_match_jax():
    """The edge inputs of the card test, at tile 32 and 96 and in both
    precisions, against the JAX package; ray tile 0 hits nothing."""
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    for G, NB, dtype in ((32, 16, torch.float32), (96, 4, torch.float64)):
        rf, tl = edge_band_inputs(G, dtype)
        want = np.asarray(jax_ray_tile_hits(
            tuple(j(f) for f in rf), tuple(j(tl[k]) for k in range(3)),
            tuple(j(tl[k]) for k in range(3, 6)), NB))
        got = ops.ray_band_bits(rf, tl, NB)
        assert np.array_equal(want, got.numpy())
        assert not bool(got[0].any()) and bool(got[1:].any())


def test_ray_band_bits_wrapper_checks():
    """What R1's wrapper refuses: other dtypes, mixed dtypes, other shapes,
    tile sizes and band counts, mixed and unsupported devices."""
    rf = torch.zeros((6, 2, 32))
    tl = torch.zeros((6, 5))
    assert tuple(ops.ray_band_bits(rf, tl).shape) == (2, 5)
    with pytest.raises(TypeError, match="float32 or torch.float64"):
        ops.ray_band_bits(rf.half(), tl.half())
    with pytest.raises(TypeError, match="float32 or torch.float64"):
        ops.ray_band_bits(rf.int(), tl)
    with pytest.raises(TypeError, match="tiles must be torch.float32"):
        ops.ray_band_bits(rf, tl.double())
    with pytest.raises(ValueError, match="rfields must be"):
        ops.ray_band_bits(torch.zeros((5, 2, 32)), tl)
    with pytest.raises(ValueError, match="rfields must be"):
        ops.ray_band_bits(torch.zeros((6, 64)), tl)
    with pytest.raises(ValueError, match="tiles must be"):
        ops.ray_band_bits(rf, torch.zeros((6, 5, 1)))
    with pytest.raises(ValueError, match="tile size 48"):
        ops.ray_band_bits(torch.zeros((6, 2, 48)), tl)
    with pytest.raises(ValueError, match="tile size 2048"):
        ops.ray_band_bits(torch.zeros((6, 1, 2048)), tl)
    with pytest.raises(ValueError, match="NB must be"):
        ops.ray_band_bits(rf, tl, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ray_band_bits(torch.zeros((6, 32, 2)).transpose(1, 2), tl)
    with pytest.raises(ValueError, match="tiles is on meta"):
        ops.ray_band_bits(rf, tl.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ray_band_bits(rf.to("meta"), tl.to("meta"))


def test_ray_band_bits_plain_path_launches_nothing():
    """On CPU tensors a tile ray query takes R1's plain version on both
    routes: the launch count stays 0."""
    bvh, p, d = ray_scene("box")
    for params in (TWO_PHASE, FALLBACK):
        ops.reset_launch_counts()
        out = tb.traverse_rays_tiles_fixed(bvh, p, d, 1024,
                                           alg=tb.TileTraversal(**params))
        assert int(out[0]) > 0
        assert ops.launch_count(ops.ray_band_bits) == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("G", range(32, 1025, 32))
@pytest.mark.parametrize("NB", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ray_band_bits_matches_plain_on_card(dtype, NB, G):
    """R1 on the card equals its plain version on the card, bit for bit, at
    every tile size the ray route takes: a NaN tail, zero direction
    components, rays in face planes, a ray tile that hits nothing."""
    _card()
    rf, tl = edge_band_inputs(G, dtype, device="cuda", seed=G + NB)
    got = ops.ray_band_bits(rf, tl, NB)
    want = ops.ray_band_bits_plain(rf, tl, NB)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not bool(got[0].any()) and bool(got[1:].any())


def dragon_scene(n_tri=249_882, n_rays=100_000):
    """The 249,882-triangle reference scene as ``chip_smoke.py`` makes it
    (random triangles at unit density, seed 0) and its 100,000 rays."""
    rng = np.random.default_rng(0)
    scale = float(n_tri) ** (1.0 / 3.0)
    c = (rng.random((n_tri, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n_tri, 3)) - 0.5).astype(np.float32) * 0.4
    rng = np.random.default_rng(1)
    p = (rng.random((3, n_rays)) * scale).astype(np.float32)
    d = (rng.random((3, n_rays)) - 0.5).astype(np.float32)
    return (c, c + e1, c + e2), p, d


@pytest.mark.gpu
def test_ray_query_on_card_launches_r1_once():
    """One ``traverse_rays_tiles_fixed`` on the card launches R1 exactly
    once on each route, and the 100,000-ray bundle on the 249,882-triangle
    scene gives the same hits, checks and overflow as with R1's plain
    version in its place."""
    _card()
    tris, p, d = dragon_scene()
    vol = tb.bsphere_from_triangles(*(
        tuple(torch.as_tensor(np.ascontiguousarray(v[:, k]), device="cuda")
              for k in range(3)) for v in tris))
    bvh = tb.build(vol)
    rp, rd = torch.as_tensor(p, device="cuda"), torch.as_tensor(d, device="cuda")

    def query(alg=None):
        ops.reset_launch_counts()
        t, c, o, n = tb.traverse_rays_tiles_fixed(bvh, rp, rd, 1 << 18,
                                                  alg=alg)
        hits = {tuple(r) for r in c[:int(t)].tolist()}
        return (int(t), int(o), float(n), len(hits)), hits, \
            ops.launch_count(ops.ray_band_bits)

    for alg in (None, tb.TileTraversal(row_cap=32, pair_cap=512)):
        got, got_hits, launches = query(alg)
        assert launches == 1 and got[1] == 0 and got[0] == got[3] > 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tray, "ray_band_bits", ops.ray_band_bits_plain)
            want, want_hits, plain_launches = query(alg)
        assert plain_launches == 0
        assert got == want and got_hits == want_hits
    assert got[0] == 196_130      # the JAX package's total on a TPU v5e
