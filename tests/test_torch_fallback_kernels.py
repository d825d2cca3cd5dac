"""The fallback route's kernels against the JAX package's Pallas kernels.

The pair-granularity fallback of tile self-contact runs the band-bit kernel
on 4 folded bands, the compaction ``compact_flat`` (``tile_compact`` and
``finish_compact`` in one call) and the slot kernel ``tile_group_contacts``; ``tile_pair_contacts`` is the slot kernel
over a packed pair list.  Each scene runs through the port's fallback on the
CPU while a recorder keeps the kernel wrappers' arguments (there they take
their plain PyTorch versions); the same arguments, as numpy arrays, go to
the JAX package's kernels in interpret mode.  Every comparison is exact:
the predicates compare identically rounded float32 values and every output
is an integer.  Slot lanes that no contact fills hold -1 in the port below
each pair's count (0 in the Pallas kernels), so lanes are compared with
Pallas where the plain version filled them; on a scene without overflow
that is every lane below each pair's count.

``gpu``-marked tests hold the CUDA kernels against their plain versions on
the same inputs, every lane below each count included; they skip without a
card.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    from implicitbvh_tpu.ops import compaction as jax_compaction
    from implicitbvh_tpu.ops.subtile import subtile_band_bits as jax_bits
    from implicitbvh_tpu.ops.tile_contact import _seg
    from implicitbvh_tpu.ops.tile_contact import \
        tile_group_contacts as jax_group_contacts
    from implicitbvh_tpu.ops.tile_contact import \
        tile_pair_contacts as jax_pair_contacts
except ImportError:
    jnp = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch.traverse import tiles as ttiles

RECORDED = ("subtile_band_bits", "compact_flat", "tile_group_contacts")


def spheres(n, seed, scale):
    rng = np.random.default_rng(seed)
    xs = (rng.random((n, 3)) * scale).astype(np.float32)
    rs = (rng.random(n) * 0.4 + 0.05).astype(np.float32)
    return xs, rs


# (leaf kind, leaves, seed, scale, traversal parameters, capacity): slot
# caps of 16/256 rather than 32/512, since the Pallas kernel unrolls its
# ROW_CAP loop in interpret mode
SCENES = {
    "sphere": ("sphere", 2048, 0, 11.0,
               dict(tile=32, count_w=2, row_cap=16, pair_cap=256), 4096),
    "box": ("box", 1500, 1, 14.0,
            dict(tile=32, count_w=2, row_cap=16, pair_cap=256, bands=8),
            4096),
    # a capacity that is not a multiple of 1024, default slot caps
    "small_capacity": ("sphere", 500, 4, 6.0, dict(tile=32, count_w=2), 512),
    # a dense cluster: rows over ROW_CAP, pairs over CAP_PAIR (and more
    # contacts than the capacity)
    "dense": ("sphere", 160, 5, 1.2,
              dict(tile=32, count_w=2, row_cap=2, pair_cap=128), 1000),
}


def volume(kind, xs, rs):
    if kind == "sphere":
        return tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs))
    return tb.BBox(torch.from_numpy(xs - rs[:, None]),
                   torch.from_numpy(xs + rs[:, None]))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """``(name, {kernel: (args, kwargs)}, bvh)`` of one fallback run."""
    kind, n, seed, scale, params, capacity = SCENES[request.param]
    bvh = tb.build(volume(kind, *spheres(n, seed, scale)))
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in RECORDED:
            fn = getattr(ttiles, k)

            def rec(*args, _k=k, _fn=fn, **kw):
                seen[_k] = (args, kw)
                return _fn(*args, **kw)
            mp.setattr(ttiles, k, rec)
        tb.traverse_tiles_fixed(bvh, capacity,
                                alg=tb.TileTraversal(**params))
    assert set(seen) == set(RECORDED)
    return request.param, seen, bvh


def j(t):
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    return jnp.asarray(t.numpy())


def assert_slots_equal(gi, gj, counts, overflow, want_gi, want_gj, CAP_PAIR):
    """Lanes below each pair's count that ``gi`` (a plain version's result)
    filled must hold ``want_gi``/``want_gj``; without overflow every lane
    below the count is filled."""
    gi, gj = gi.cpu().numpy(), gj.cpu().numpy()
    counts = counts.cpu().numpy()
    below = np.arange(CAP_PAIR)[None, :] < np.minimum(counts, CAP_PAIR)[:, None]
    filled = below & (gi >= 0)
    if not bool(overflow):
        assert np.array_equal(filled, below)
    assert np.array_equal(np.asarray(want_gi)[filled], gi[filled])
    assert np.array_equal(np.asarray(want_gj)[filled], gj[filled])
    return int(filled.sum())


def assert_lanes_equal(got, want, CAP_PAIR):
    """A slot kernel's ``(gi, gj, counts)`` on the card against its plain
    version's: every lane below each pair's count and CAP_PAIR, including
    the -1 lanes of a row over ROW_CAP."""
    gi, gj, c = (t.cpu() for t in got)
    pgi, pgj, pc = (t.cpu() for t in want)
    below = torch.arange(CAP_PAIR)[None, :] < pc.clamp(max=CAP_PAIR)[:, None]
    assert torch.equal(c, pc)
    assert torch.equal(gi[below], pgi[below])
    assert torch.equal(gj[below], pgj[below])


def test_band_bits_plain_matches_pallas_folded(scene):
    """B1 on the fallback's 4 folded bands."""
    _, seen, _ = scene
    (sub, tiles, si, sj, nsp), kw = seen["subtile_band_bits"]
    assert sub.shape[2] == 4
    want = jax_bits(tuple(j(sub[k]) for k in range(3)),
                    tuple(j(sub[k]) for k in range(3, 6)),
                    tuple(j(tiles[k]) for k in range(3)),
                    tuple(j(tiles[k]) for k in range(3, 6)),
                    j(si), j(sj), j(nsp), Ta=sub.shape[1], Tb=tiles.shape[1],
                    triangle=kw["triangle"], n_bands=4,
                    interpret=True)[:, :, :32]
    got = ops.subtile_band_bits_plain(sub, tiles, si, sj, nsp, **kw)
    assert int((got != 0).sum()) > 0
    assert np.array_equal(np.asarray(want), got.numpy())


def test_compact_plain_matches_pallas_on_path(scene):
    """B5 at the inputs the fallback's phase 1 gives it."""
    _, seen, _ = scene
    (mask, payloads), kw = seen["compact_flat"]
    capacity = kw["capacity"]
    kw = {k: v for k, v in kw.items() if k != "capacity"}
    want_s, want_c, want_o = jax_compaction.tile_compact(
        j(mask), tuple(j(p).astype(jnp.float32) for p in payloads),
        interpret=True, **kw)
    got_s, got_c, got_o = ops.tile_compact_plain(mask, payloads, **kw)
    assert int(got_c.sum()) > 0
    for w, g in zip(want_s, got_s):
        assert np.array_equal(np.asarray(w).astype(np.int32), g.numpy())
    assert np.array_equal(np.asarray(want_c), got_c.numpy())
    assert bool(want_o) == bool(got_o) is False
    # the path's whole compaction: finish_compact of the Pallas slots
    want_l, want_t = jax_compaction.finish_compact(want_s, want_c, capacity)
    got_l, got_t, got_o = ops.compact_flat_plain(mask, payloads,
                                                 capacity=capacity, **kw)
    assert int(want_t) == int(got_t) and bool(got_o) is False
    for w, g in zip(want_l, got_l):
        assert np.array_equal(np.asarray(w).astype(np.int32), g.numpy())


def test_group_contacts_plain_matches_pallas(scene):
    """B4: counts and overflow exactly, and the filled slot lanes."""
    name, seen, _ = scene
    (a_idx, b_idx, nsteps, fields), kw = seen["tile_group_contacts"]
    C = kw["CAP_PAIR"]
    slots, counts, over = jax_group_contacts(
        j(a_idx), j(b_idx), j(nsteps), tuple(j(f) for f in fields),
        mask_kind=kw["mask_kind"], G=fields.shape[2],
        W=b_idx.shape[0] // a_idx.shape[0], ROW_CAP=kw["ROW_CAP"],
        CAP_PAIR=C, dedup=kw["dedup"], interpret=True)
    gi, gj, got_c, got_o = ops.tile_group_contacts_plain(
        a_idx, b_idx, nsteps, fields, **kw)
    assert np.array_equal(np.asarray(counts), got_c.numpy())
    assert bool(over) == bool(got_o)
    if name in ("sphere", "box"):
        assert not bool(got_o)
    seg = _seg(C)
    slots = np.asarray(slots)
    n = assert_slots_equal(gi, gj, got_c, got_o, slots[:, :C],
                           slots[:, seg:seg + C], C)
    assert n > 0
    if name == "dense":
        assert bool(got_o) and int(got_c.max()) > C


def test_group_contacts_plain_matches_pallas_without_dedup(scene):
    """B4 with ``dedup=False`` (every ordered leaf pair of a diagonal
    entry, as the two-tree route will take it) on the scene's inputs."""
    _, seen, _ = scene
    (a_idx, b_idx, nsteps, fields), kw = seen["tile_group_contacts"]
    kw = dict(kw, dedup=False)
    C = kw["CAP_PAIR"]
    slots, counts, over = jax_group_contacts(
        j(a_idx), j(b_idx), j(nsteps), tuple(j(f) for f in fields),
        mask_kind=kw["mask_kind"], G=fields.shape[2],
        W=b_idx.shape[0] // a_idx.shape[0], ROW_CAP=kw["ROW_CAP"],
        CAP_PAIR=C, dedup=False, interpret=True)
    gi, gj, got_c, got_o = ops.tile_group_contacts_plain(
        a_idx, b_idx, nsteps, fields, **kw)
    assert np.array_equal(np.asarray(counts), got_c.numpy())
    assert bool(over) == bool(got_o)
    with_dedup = ops.tile_group_contacts_plain(a_idx, b_idx, nsteps, fields,
                                               **dict(kw, dedup=True))[2]
    assert int(got_c.sum()) > int(with_dedup.sum())
    seg = _seg(C)
    slots = np.asarray(slots)
    assert assert_slots_equal(gi, gj, got_c, got_o, slots[:, :C],
                              slots[:, seg:seg + C], C) > 0


def test_pair_contacts_plain_matches_pallas(scene):
    """B6 on the packed pair list of the scene's phase 1."""
    _, seen, bvh = scene
    (a_idx, b_idx, nsteps, fields), kw = seen["tile_group_contacts"]
    _, _, tiles, sub, _ = ttiles._tiled_fields(bvh, fields.shape[2], 4)
    packed, _, npairs = ttiles._phase1_tile_pairs(tiles, sub, 8192)
    n = -(-int(npairs) // 8) * 8          # the live prefix, batch-aligned
    packed, npairs = packed[:n].contiguous(), npairs.reshape(1)
    C = kw["CAP_PAIR"]
    slots, counts, over = jax_pair_contacts(
        j(packed), j(npairs), tuple(j(f) for f in fields),
        mask_kind=kw["mask_kind"], G=fields.shape[2], ROW_CAP=kw["ROW_CAP"],
        CAP_PAIR=C, dedup=True, interpret=True, batch=8)
    gi, gj, got_c, got_o = ops.tile_pair_contacts_plain(
        packed, npairs, fields, **kw)
    assert np.array_equal(np.asarray(counts), got_c.numpy())
    assert bool(over) == bool(got_o)
    seg = _seg(C)
    slots = np.asarray(slots)
    assert assert_slots_equal(gi, gj, got_c, got_o, slots[:, :C],
                              slots[:, seg:seg + C], C) > 0


MEGA = 128 * 128
COMPACT_CASES = ("sparse", "tile_over_cap", "row_over_row_cap", "empty")


def compact_inputs(case):
    rng = np.random.default_rng(COMPACT_CASES.index(case))
    M = 2 * MEGA
    if case == "sparse":
        mask = rng.random(M) < 0.01
    elif case == "tile_over_cap":
        mask = rng.random(M) < np.where(np.arange(M) < MEGA, 0.5, 0.01)
    elif case == "row_over_row_cap":
        mask = rng.random(M) < 0.01
        mask[MEGA + 128 * 7:MEGA + 128 * 7 + 10] = True   # 10 in one row
    else:
        mask = np.zeros(M, bool)
    pay = [rng.integers(0, 1 << 20, M).astype(np.int32) for _ in range(2)]
    return mask, pay


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_plain_matches_pallas(case):
    """B5 on numpy masks: whole slot arrays, counts and overflow, then
    ``finish_compact``'s lists and total."""
    mask, pay = compact_inputs(case)
    cap, row_cap = 256, 8
    if jnp is None:
        pytest.skip("needs JAX and the implicitbvh_tpu package")
    want_s, want_c, want_o = jax_compaction.tile_compact(
        jnp.asarray(mask), tuple(jnp.asarray(p, jnp.float32) for p in pay),
        cap=cap, row_cap=row_cap, interpret=True)
    got_s, got_c, got_o = ops.tile_compact_plain(
        torch.from_numpy(mask), tuple(torch.from_numpy(p) for p in pay),
        cap=cap, row_cap=row_cap)
    for w, g in zip(want_s, got_s):
        assert np.array_equal(np.asarray(w).astype(np.int32), g.numpy())
    assert np.array_equal(np.asarray(want_c), got_c.numpy())
    assert bool(want_o) == bool(got_o) == (case in ("tile_over_cap",
                                                     "row_over_row_cap"))
    for capacity in (512, 4096):
        want_l, want_t = jax_compaction.finish_compact(want_s, want_c,
                                                       capacity)
        got_l, got_t = ops.finish_compact(got_s, got_c, capacity)
        assert int(want_t) == int(got_t)
        for w, g in zip(want_l, got_l):
            assert np.array_equal(np.asarray(w), g.numpy())


def test_compact_one_payload_and_checks():
    """The wrapper takes exactly two int32 payloads of the mask's length;
    on CPU tensors it returns its plain version's result."""
    mask, pay = compact_inputs("sparse")
    m = torch.from_numpy(mask)
    p, q = (torch.from_numpy(x) for x in pay)
    (s1, s2), c, o = ops.tile_compact(m, (p, q), cap=256, row_cap=8)
    (w1, w2), wc, wo = ops.tile_compact_plain(m, (p, q), cap=256, row_cap=8)
    assert torch.equal(s1, w1) and torch.equal(s2, w2)
    assert torch.equal(c, wc) and bool(o) == bool(wo) is False
    for bad in ((p,), (p, q, q)):
        with pytest.raises(ValueError):
            ops.tile_compact(m, bad, cap=256, row_cap=8)
    with pytest.raises(ValueError):
        ops.tile_compact(m[:1000], (p[:1000], q[:1000]), cap=256, row_cap=8)
    with pytest.raises(TypeError):
        ops.tile_compact(m, (p.long(), q), cap=256, row_cap=8)


def _on_card(seen_args):
    return tuple(a.cuda() if isinstance(a, torch.Tensor) else
                 tuple(x.cuda() for x in a) for a in seen_args)


@pytest.mark.gpu
def test_fallback_kernels_match_plain_on_card(scene):
    """B4, B5 and B6 on the card equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    _, seen, bvh = scene
    args, kw = seen["compact_flat"]
    args = _on_card(args)
    for g, w in zip(ops.compact_flat(*args, **kw),
                    ops.compact_flat_plain(*args, **kw)):
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(x, y)
    kw = {k: v for k, v in kw.items() if k != "capacity"}
    for g, w in zip(ops.tile_compact(*args, **kw),
                    ops.tile_compact_plain(*args, **kw)):
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(x, y)
    args, kw = seen["tile_group_contacts"]
    args = _on_card(args)
    for dedup in (True, False):
        gi, gj, c, o = ops.tile_group_contacts(*args, **dict(kw, dedup=dedup))
        pgi, pgj, pc, po = ops.tile_group_contacts_plain(
            *args, **dict(kw, dedup=dedup))
        assert torch.equal(c, pc) and bool(o) == bool(po)
        assert_lanes_equal((gi, gj, c), (pgi, pgj, pc), kw["CAP_PAIR"])
    fields = args[3]
    _, _, tiles, sub, _ = ttiles._tiled_fields(bvh, fields.shape[2], 4)
    packed, _, npairs = ttiles._phase1_tile_pairs(tiles, sub, 8192)
    packed, npairs = packed.cuda(), npairs.reshape(1).cuda()
    gi, gj, c, o = ops.tile_pair_contacts(packed, npairs, fields, **kw)
    pgi, pgj, pc, po = ops.tile_pair_contacts_plain(packed, npairs, fields,
                                                    **kw)
    assert torch.equal(c, pc) and bool(o) == bool(po)
    assert_lanes_equal((gi, gj, c), (pgi, pgj, pc), kw["CAP_PAIR"])
