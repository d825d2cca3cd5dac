"""The tile engine in float64 against the JAX package with x64, on the CPU.

``tests/conftest.py`` turns on ``jax_enable_x64``, so the JAX package's tile
engine keeps float64 leaves in float64 (its kernels in interpret mode).
The port's tile engine takes float32 and float64 volumes and trees of two
precisions; on CPU tensors its kernels run as their plain versions, which
compute in the fields' dtype.  Held here, exactly (every predicate is a
comparison of identically rounded float64 values, every count an
integer):

- self-contact of 2,500 random spheres in float64 (tile 64) on both
  routes, with ``decode_k=8``, and over BSphere nodes, against one call
  of the JAX package's tile engine (its fallback route: total, overflow
  and ``num_checks`` equal there, the set on every route) and a brute
  force in float64;
- a near-touching scene, 500 pairs of spheres of radius 0.01 whose centres
  lie 2r(1 + 1e-10) apart: apart in float64 (no contact, as the JAX
  package's walk finds), touching once rounded to float32, so a float32
  cast of the engine's inputs fails here;
- growth into the fallback in float64 (the dense cluster of
  ``test_torch_fallback.py``), against the JAX package's walk and a brute
  force, and growth's end in the walk (coincident spheres, one tree and a
  float32 tree against a float64 one);
- the sharded local tile function at 8 ranks, against the port's own
  single-device float64 answer.

Two trees, mixed precisions and rays are in
``test_torch_tiles_f64_pair_rays.py``.  The ``gpu`` case holds the card's
``<double>`` kernels against the CPU on these scenes.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu.traverse import TileTraversal as JTile
    from implicitbvh_tpu.traverse import tiles as jtiles
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch.parallel import sharding as ts

F64 = np.float64
CAP = 4096
G = 64
N_DEV = 8
TWO_PHASE = dict(tile=G, row_cap=8, pair_cap=128)
FALLBACK = dict(tile=G, row_cap=32, pair_cap=512)
ROUTES = {"two_phase": TWO_PHASE, "fallback": FALLBACK,
          "decode_k8": dict(TWO_PHASE, decode_k=8)}


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


def spheres(n, seed, dtype=F64):
    """n random spheres in a cube of side n^(1/3), radii 0.05-0.45."""
    rng = np.random.default_rng(seed)
    xs = (rng.random((n, 3)) * n ** (1 / 3)).astype(dtype)
    rs = (rng.random(n) * 0.4 + 0.05).astype(dtype)
    return xs, rs


def near_touching(n_pairs=500, seed=7):
    """Pairs of spheres of radius 0.01 whose centres lie 2r(1 + 1e-10)
    apart along a random direction, one pair per cell of a unit lattice:
    no contact in float64, contacts once rounded to float32."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n_pairs ** (1 / 3)))
    cell = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n_pairs].astype(F64)
    c = cell + 0.25 + rng.random((n_pairs, 3)) * 0.5
    u = rng.normal(size=(n_pairs, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 0.01
    xs = np.concatenate([c, c + u * (2 * r * (1 + 1e-10))])
    return xs, np.full(2 * n_pairs, r, F64)


def brute_force(xs, rs):
    """1-based (i, j), i < j, of every sphere pair in contact, in the
    kernels' operation order, in the spheres' dtype."""
    out = set()
    for i0 in range(0, len(rs), 512):
        d = [xs[i0:i0 + 512, None, k] - xs[None, :, k] for k in range(3)]
        rr = rs[i0:i0 + 512, None] + rs[None, :]
        hit = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= rr * rr
        for i, j in zip(*np.nonzero(hit)):
            if i0 + i < j:
                out.add((int(i0 + i) + 1, int(j) + 1))
    return out


def jax_bvh(xs, rs):
    return jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox)


def to_port(jbvh):
    from test_torch_pair import to_port as carry
    return carry(jbvh)


def port_bvh(xs, rs, node_kind=tb.BBox, device="cpu"):
    return tb.build(tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs),
                               device=device), node_kind)


def pairs(total, contacts):
    if isinstance(contacts, torch.Tensor):
        contacts = contacts.cpu()
    return sorted(map(tuple, np.asarray(contacts)[:int(total)].tolist()))


def summary(out):
    """(sorted pairs, total, overflow, num_checks) of a ``*_fixed`` call."""
    total, contacts, overflow, num_checks = out
    return (pairs(total, contacts), int(total), int(overflow),
            float(num_checks))


@pytest.fixture(scope="module")
def self_scene():
    """The float64 scene, its JAX BVH carried into the port, and the JAX
    package's tile engine on it (fallback route, one call)."""
    xs, rs = spheres(2500, 0)
    jbvh = jax_bvh(xs, rs)
    want = summary(jtiles.traverse_tiles_fixed(jbvh, CAP,
                                               alg=JTile(**FALLBACK)))
    return xs, rs, to_port(jbvh), want


def test_self_wrapper_matches_jax_and_brute_force(self_scene):
    """``traverse_tiles`` on the float64 BVH gives the JAX package's set,
    which is the float64 brute force's."""
    xs, rs, tbvh, want = self_scene
    assert tbvh.leaves.volume.dtype == torch.float64
    assert want[2] == 0 and 500 < want[1] < CAP
    assert set(want[0]) == brute_force(xs, rs)
    res = tb.traverse_tiles(tbvh, alg=tb.TileTraversal(tile=G))
    assert sorted(res.contacts_list()) == want[0]


def test_self_fallback_matches_jax_exactly(self_scene):
    """The same route: the set, the total, the overflow bits and
    ``num_checks``."""
    _, _, tbvh, want = self_scene
    got = summary(tb.traverse_tiles_fixed(tbvh, CAP,
                                          alg=tb.TileTraversal(**FALLBACK)))
    assert got == want


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("nodes", ["box", "sphere"])
def test_self_routes_and_node_kinds_match_jax(self_scene, route, nodes):
    """Both routes and the moment decode, over the JAX package's BVH (BBox
    nodes) and over the port's own BSphere-node build of the same spheres,
    give the JAX package's set with no overflow."""
    xs, rs, tbvh, want = self_scene
    if nodes == "sphere":
        tbvh = port_bvh(xs, rs, tb.BSphere)
    t, c, o, _ = tb.traverse_tiles_fixed(tbvh, CAP,
                                         alg=tb.TileTraversal(**ROUTES[route]))
    assert int(o) == 0
    assert pairs(t, c) == want[0]


def test_traverse_takes_float64_on_the_tile_engine(self_scene):
    """``traverse(bvh, TileTraversal())`` with growth, as the user calls
    it."""
    _, _, tbvh, want = self_scene
    res = tb.traverse(tbvh, tb.TileTraversal(tile=G))
    assert sorted(res.contacts_list()) == want[0]


def test_near_touching_scene_is_apart_in_float64():
    """0 contacts in float64 on both routes, as the JAX package's walk
    finds; the same spheres rounded to float32 touch, so an engine that
    computed in float32 would list them."""
    xs, rs = near_touching()
    jres = jb.traverse(jax_bvh(xs, rs), jb.LVTTraversal())
    assert jres.num_contacts == 0
    assert brute_force(xs, rs) == set()
    tbvh = port_bvh(xs, rs)
    for route in ("two_phase", "fallback"):
        t, c, o, _ = tb.traverse_tiles_fixed(
            tbvh, CAP, alg=tb.TileTraversal(**ROUTES[route]))
        assert (int(t), int(o)) == (0, 0), route
    x32, r32 = xs.astype(np.float32), rs.astype(np.float32)
    t32 = summary(tb.traverse_tiles_fixed(port_bvh(x32, r32), CAP,
                                          alg=tb.TileTraversal(tile=G)))
    assert t32[1] > 100 and set(t32[0]) == brute_force(x32, r32)


def test_growth_into_the_fallback_in_float64():
    """The dense cluster grows from row_cap 2 / pair_cap 4 into the
    fallback and ends with the JAX package's walk set, in float64."""
    rng = np.random.default_rng(5)
    xs = rng.random((96, 3)) * 0.8
    rs = rng.random(96) * 0.4 + 0.05
    tt = tb.traverse_tiles(port_bvh(xs, rs),
                           alg=tb.TileTraversal(tile=32, row_cap=2,
                                                pair_cap=4))
    jt = jb.traverse(jax_bvh(xs, rs), jb.LVTTraversal())
    assert sorted(tt.contacts_list()) == sorted(jt.contacts_list())
    assert set(tt.contacts_list()) == brute_force(xs, rs)
    assert tt.tile_alg.pair_cap > 128          # grown past the two-phase


def test_growth_end_takes_the_float64_walk():
    """Coincident float64 spheres, more contacts in one tile pair than
    ``MAX_PAIR_CAP``: tile growth ends in the walk, in float64, for one
    BVH and for a float32 tree against a float64 one."""
    from implicitbvh_tpu_torch.traverse import tiles as ttiles
    alg = tb.TileTraversal(tile=64)
    n = 48            # 48 * 47 / 2 = 1128 self pairs in one tile
    bvh = port_bvh(np.zeros((n, 3)), np.full(n, 0.5))
    t = tb.traverse_tiles(bvh, alg=alg)
    assert n * (n - 1) // 2 > ttiles.MAX_PAIR_CAP
    assert t.tile_alg is None and set(t.contacts_list()) == {
        (i, j) for i in range(1, n + 1) for j in range(i + 1, n + 1)}
    n = 40
    b32 = port_bvh(np.zeros((n, 3), np.float32), np.full(n, 0.5, np.float32))
    t = tb.traverse_tiles_pair(b32, port_bvh(np.zeros((n, 3)),
                                             np.full(n, 0.5)), alg=alg)
    assert t.tile_alg is None and t.num_contacts == n * n


def test_sharded_tile_self_contact_at_8_ranks(self_scene):
    """The ranks' disjoint slices make the single-device float64 set."""
    _, _, tbvh, want = self_scene
    alg = tb.TileTraversal(**TWO_PHASE)
    rows, total = [], 0
    for rank in range(N_DEV):
        t, c, o = ts._local_sharded_tile_self_contact(tbvh, 1024, rank,
                                                      N_DEV, alg=alg)
        assert not bool(o), rank
        rows += pairs(t, c)
        total += int(t)
    assert total == len(rows) == len(set(rows))
    assert sorted(rows) == want[0]


@pytest.mark.gpu
def test_float64_self_on_card_equals_cpu():
    """The ``<double>`` kernels on both routes, with the moment decode, and
    the near-touching scene: the card's sets equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from implicitbvh_tpu_torch import ops
    for xs, rs in (spheres(2500, 0), near_touching()):
        cpu, gpu = port_bvh(xs, rs), port_bvh(xs, rs, device="cuda")
        for route, params in ROUTES.items():
            alg = tb.TileTraversal(**params)
            ops.reset_launch_counts()
            got = summary(tb.traverse_tiles_fixed(gpu, CAP, alg=alg))
            assert ops.launch_count(ops.subtile_band_bits) == 1, route
            assert got == summary(tb.traverse_tiles_fixed(cpu, CAP,
                                                          alg=alg)), route
