"""The port's extended Morton order (``ExtendedMortonAlgorithm``) against the
JAX package, on the CPU.

Sphere and box leaves made by numpy from a seed are encoded by both
packages at 16, 32 and 64 bits, with computed and fixed extrema and the
size bits on, off, and with and without their square root; the split
schedule, ``morton_encode_single``, a 64-bit extended build and the
contact sets of ``tests/test_extended_morton.py``'s scenes are compared
too.  Tolerance: exact.  Codes are compared bit for bit (the JAX package's
unsigned codes, x64 on in ``tests/conftest.py``, against the port's int64
bit patterns); the build's leaves, nodes and skips must be equal, in order.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import morton as jm
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import morton as tm

CPU = torch.device("cpu")

# size-bit settings: the width's defaults, none, no square root, and a
# square root at a non-default interval and budget
SIZE_OPTS = [{}, dict(size_interval=0), dict(use_sqrt_size=0),
             dict(size_interval=5, size_budget=3, use_sqrt_size=1)]


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def leaves(n, seed, stretch=(1.0, 1.0, 1.0), r=None):
    """Centres at about unit density, stretched per axis, and radii (random
    in [0.05, 0.55), or all ``r``)."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)).astype(np.float32) * np.float32(n ** (1 / 3))
    c *= np.asarray(stretch, np.float32)
    rs = np.full((n,), np.float32(r)) if r is not None else \
        (rng.random(n) * 0.5 + 0.05).astype(np.float32)
    return c, rs


def both_volumes(c, rs, box):
    """The same leaves in both packages: spheres, or boxes stretched
    unevenly around the centres (so the diagonal is not 2r)."""
    if box:
        lo = c - rs[:, None]
        up = c + rs[:, None] * np.asarray([1.7, 0.4, 1.1], np.float32)
        return (jb.BBox(jnp.asarray(lo), jnp.asarray(up)),
                tb.BBox(lo, up, device=CPU))
    return (jb.BSphere(jnp.asarray(c), jnp.asarray(rs)),
            tb.BSphere(c, rs, device=CPU))


def as_int64(codes):
    """The JAX package's unsigned codes as int64 bit patterns."""
    a = np.asarray(codes)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


def both_algs(bits, **kw):
    return (jm.ExtendedMortonAlgorithm(bits=bits, **kw),
            tm.ExtendedMortonAlgorithm(bits=bits, **kw))


@pytest.mark.parametrize("extrema", ["computed", "fixed"])
@pytest.mark.parametrize("kind", ["sphere", "box"])
@pytest.mark.parametrize("bits", [16, 32, 64])
def test_codes_match_jax(bits, kind, extrema):
    c, rs = leaves(600, bits, stretch=(6.0, 1.0, 0.3))
    jv, tv = both_volumes(c, rs, kind == "box")
    fixed = {} if extrema == "computed" else dict(
        compute_extrema=False, mins=(-1.0, -2.0, -0.5),
        maxs=(60.0, 10.5, 3.25))
    top = 0
    for kw in SIZE_OPTS:
        ja, ta = both_algs(bits, **fixed, **kw)
        want = as_int64(jm.morton_encode_extended(jv, ja))
        got = tm.morton_encode_extended(tv, ta)
        assert got.dtype == torch.int64
        assert np.array_equal(want, got.numpy()), kw
        top += int((got < 0).sum())
    if bits == 64:    # bit 63 is set for some codes and not for others
        assert 0 < top < 600 * len(SIZE_OPTS)
    else:
        assert top == 0


def test_options_normalise_as_in_jax():
    for bits in (16, 32, 64):
        for interval in (-1, 0, 3, 7, 20):
            for budget in (-1, 0, 2, 9):
                for sq in (-1, 0, 1):
                    ja, ta = both_algs(bits, size_interval=interval,
                                       size_budget=budget, use_sqrt_size=sq)
                    assert (ja.size_interval, ja.size_budget,
                            ja.use_sqrt_size, ja.size_slots) == \
                        (ta.size_interval, ta.size_budget,
                         ta.use_sqrt_size, ta.size_slots)
    with pytest.raises(ValueError):
        tm.ExtendedMortonAlgorithm(bits=48)


SCHEDULE_RANGES = {
    "long_x": (8.0, 1.0, 1.0),         # tests/test_extended_morton.py:41-57
    "cube": (2.0, 2.0, 2.0),
    "flat_z": (3.0, 5.0, 1e-3),
    "line": (7.0, 0.0, 0.0),           # two zero-extent axes: the 24-bit cap
    "point": (0.0, 0.0, 0.0),          # no eligible axis: the fallback cycle
    "non_finite": (np.inf, np.nan, 2.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_RANGES))
def test_schedule_matches_jax(name):
    ranges = SCHEDULE_RANGES[name]
    for bits in (16, 32, 64):
        for kw in ({}, dict(size_interval=0)):
            ja, ta = both_algs(bits, **kw)
            jaxes, jcounts = jm._extended_schedule(
                tuple(jnp.float32(r) for r in ranges), ja)
            taxes, tcounts = tm._extended_schedule(
                np.asarray(ranges, np.float32), ta)
            assert [a if isinstance(a, str) else int(a) for a in jaxes] == \
                taxes
            assert np.array_equal(np.asarray(jcounts), tcounts)
    if name == "line":
        assert tcounts.tolist() == [24, 24, 16]    # x capped, then the cycle


def test_exp2_matches_jax_at_every_count():
    """``2^c - 1`` per axis as the JAX package computes it (not exact above
    2^12), at every count an axis can hold."""
    k = np.arange(tm._AXIS_BIT_CAP + 1, dtype=np.int32)
    want = np.asarray(jnp.exp2(jnp.asarray(k, jnp.float32)))
    assert np.array_equal(want, tm._exp2_f32(k))


@pytest.mark.parametrize("bits", [16, 64])
def test_degenerate_scene_codes_match_jax(bits):
    """Leaves on a line along x (two zero-extent axes) and all at one
    point: the cap of 24 bits per axis and the fallback cycle."""
    n = 300
    rng = np.random.default_rng(5)
    line = np.zeros((n, 3), np.float32)
    line[:, 0] = rng.random(n).astype(np.float32) * 50
    point = np.full((n, 3), 1.5, np.float32)
    rs = (rng.random(n) * 0.5 + 0.05).astype(np.float32)
    for c in (line, point):
        for box in (False, True):
            jv, tv = both_volumes(c, rs, box)
            ja, ta = both_algs(bits)
            assert np.array_equal(
                as_int64(jm.morton_encode_extended(jv, ja)),
                tm.morton_encode_extended(tv, ta).numpy())


def test_morton_encode_single_matches_jax():
    rng = np.random.default_rng(9)
    mins, maxs = (-1.0, 0.0, -3.0), (4.0, 2.5, 3.0)
    for bits in (16, 32, 64):
        alg_j = jb.DefaultMortonAlgorithm(bits=bits)
        alg_t = tb.DefaultMortonAlgorithm(bits=bits)
        for c in rng.random((5, 3)) * [4.9, 2.4, 5.9] + [-1, 0, -3]:
            want = int(jb.morton_encode_single(c, mins, maxs, alg_j))
            got = tb.morton_encode_single(c, mins, maxs, alg_t, device=CPU)
            assert got.dtype == torch.int64 and got.dim() == 0
            assert int(got) == want


def test_64bit_extended_build_matches_jax():
    """The build sorts on the codes' unsigned order: leaves, codes, nodes
    and skips in the JAX package's order, although some codes set bit 63
    (a signed sort of the same codes would put those first)."""
    c, rs = leaves(700, 3, stretch=(3.0, 1.0, 1.0))
    jv, tv = both_volumes(c, rs, False)
    ja, ta = both_algs(64)
    jbvh = jb.build(jv, jb.BBox, options=jb.BVHOptions(morton=ja))
    tbvh = tb.build(tv, options=tb.BVHOptions(morton=ta))
    codes = tbvh.leaves.morton
    assert np.array_equal(as_int64(jbvh.leaves.morton), codes.numpy())
    assert 0 < int((codes < 0).sum()) < 700
    assert not torch.equal(torch.sort(codes).values, codes)
    for a, b in [(jbvh.leaves.index, tbvh.leaves.index),
                 (jbvh.skips, tbvh.skips), (jbvh.leaves.volume.r,
                                            tbvh.leaves.volume.r),
                 *zip(jbvh.leaves.volume.xs, tbvh.leaves.volume.xs),
                 *zip(jbvh.nodes.los + jbvh.nodes.ups,
                      tbvh.nodes.los + tbvh.nodes.ups)]:
        assert np.array_equal(np.asarray(a), b.numpy())


def test_contact_set_independent_of_the_order():
    """tests/test_extended_morton.py:87-95: an extended-order BVH gives the
    default order's contact set, in both packages."""
    c, rs = leaves(150, 2, stretch=(20.0, 1.0, 1.0), r=0.5)
    jv, tv = both_volumes(c, rs, False)
    ja, ta = both_algs(32)
    want = jb.traverse(jb.build(jv, jb.BBox,
                                options=jb.BVHOptions(morton=ja)))
    got = tb.traverse(tb.build(tv, options=tb.BVHOptions(morton=ta)))
    default = tb.traverse(tb.build(tv))
    assert sorted(got.contacts_list()) == \
        sorted(map(tuple, want.contacts_list())) == \
        sorted(default.contacts_list())
    assert got.num_contacts > 0


def test_elongated_scene_order_and_contacts():
    """tests/test_extended_morton.py:98-112: on a 100:1 scene the port's
    extended order is the JAX package's leaf for leaf and at least halves
    the mean distance between Morton neighbours; the tile engine's contact
    set is the default order's."""
    c, rs = leaves(4000, 3, stretch=(100.0, 1.0, 1.0), r=0.1)
    jv, tv = both_volumes(c, rs, False)
    ja, ta = both_algs(32, size_interval=0)
    jbvh = jb.build(jv, jb.BBox, options=jb.BVHOptions(morton=ja))
    tbvh = tb.build(tv, options=tb.BVHOptions(morton=ta))
    assert np.array_equal(np.asarray(jbvh.leaves.index),
                          tbvh.leaves.index.numpy())

    def neighbour_cost(bvh):
        xs = torch.stack(bvh.leaves.volume.xs, 1)
        return float((xs[1:] - xs[:-1]).norm(dim=1).mean())

    dflt = tb.build(tv)
    assert neighbour_cost(tbvh) <= 0.5 * neighbour_cost(dflt)
    alg = tb.TileTraversal(tile=32, count_w=2, emit_w=2)
    got = tb.traverse_tiles(tbvh, alg=alg)
    assert sorted(got.contacts_list()) == \
        sorted(tb.traverse_tiles(dflt, alg=alg).contacts_list())
    assert got.num_contacts > 0


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32, 64])
def test_extended_codes_on_card_match_cpu(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c, rs = leaves(5000, bits, stretch=(4.0, 1.0, 0.5))
    for kw in SIZE_OPTS:
        alg = tm.ExtendedMortonAlgorithm(bits=bits, **kw)
        for box in (False, True):
            up = c + rs[:, None] * np.float32(1.3)
            vols = [tb.BBox(c - rs[:, None], up, device=d) if box
                    else tb.BSphere(c, rs, device=d) for d in (CPU, "cuda")]
            want = tm.morton_encode_extended(vols[0], alg)
            got = tm.morton_encode_extended(vols[1], alg)
            assert torch.equal(got.cpu(), want), (kw, box)
