"""The PyTorch port's build against the JAX package, on the CPU.

The same triangles, made by numpy from a seed, go through
``bsphere_from_triangles``, the Morton encoding, the stable Morton sort and
the BBox-node aggregation of both packages.  Every comparison is exact: the
port repeats the JAX package's float operations in the same order with the
same rounding (a float32 square root is taken correctly rounded), and the
rest is integer arithmetic, a stable sort and min/max.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import implicitbvh_tpu as jb
from implicitbvh_tpu import morton as jax_morton
import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import interop
from implicitbvh_tpu_torch.morton import (DefaultMortonAlgorithm,
                                          morton_encode)
from implicitbvh_tpu_torch.tree import ImplicitTree, compute_skips
from implicitbvh_tpu_torch.volumes import center_coords

CPU = torch.device("cpu")


def triangles(n, seed, dup=0):
    """Random triangles at about unit density; the last ``dup`` repeat the
    first ones, so their centres share Morton codes."""
    rng = np.random.default_rng(seed)
    scale = float(n) ** (1.0 / 3.0)
    c = (rng.random((n, 3)) * scale).astype(np.float32)
    e1 = (rng.random((n, 3)) - 0.5).astype(np.float32) * 0.4
    e2 = (rng.random((n, 3)) - 0.5).astype(np.float32) * 0.4
    tri = [c, c + e1, c + e2]
    if dup:
        tri = [np.concatenate([p[:-dup], p[:dup]]) for p in tri]
    return tri


def jax_spheres(tri):
    return jb.bsphere_from_triangles(*[jnp.asarray(p) for p in tri])


def torch_spheres(tri):
    return tb.bsphere_from_triangles(*[torch.from_numpy(p) for p in tri])


def eq(a, b):
    """Exact equality of a JAX array and a torch tensor (NaN == NaN)."""
    a = np.asarray(a)
    b = b.numpy()
    return a.shape == b.shape and np.array_equal(a.astype(b.dtype), b,
                                                 equal_nan=True)


SCENES = [(3000, 0, 0), (1500, 1, 200)]


@pytest.fixture(scope="module", params=SCENES, ids=["plain", "dup_codes"])
def scene(request):
    n, seed, dup = request.param
    tri = triangles(n, seed, dup)
    return tri, jax_spheres(tri), torch_spheres(tri)


def test_bsphere_from_triangles_exact(scene):
    _, js, ts = scene
    assert all(eq(a, b) for a, b in zip(js.xs, ts.xs))
    assert eq(js.r, ts.r)


def test_bsphere_degenerate_cases_exact():
    """Collinear, right-angled and obtuse triangles take every branch."""
    p1 = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [1, 2, 3], [0, 0, 0]],
                  np.float32)
    p2 = np.array([[1, 0, 0], [2, 0, 0], [4, 0, 0], [1, 2, 3], [1, 1e-4, 0]],
                  np.float32)
    p3 = np.array([[2, 0, 0], [0, 2, 0], [1, 0.5, 0], [1, 2, 3],
                   [-1, 1e-4, 0]], np.float32)
    js, ts = jax_spheres([p1, p2, p3]), torch_spheres([p1, p2, p3])
    assert all(eq(a, b) for a, b in zip(js.xs, ts.xs))
    assert eq(js.r, ts.r)


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_morton_codes_exact(scene, bits):
    _, js, ts = scene
    jcode = jb.morton_encode(js.xs, jb.DefaultMortonAlgorithm(bits=bits))
    tcode = morton_encode(center_coords(ts), DefaultMortonAlgorithm(bits=bits))
    assert tcode.dtype == torch.int64
    assert np.array_equal(np.asarray(jcode).astype(np.int64), tcode.numpy())


def test_build_sort_and_nodes_exact(scene):
    _, js, ts = scene
    jbvh = jb.build(js, jb.BBox)
    tbvh = tb.build(ts)
    assert tbvh.leaves.index.dtype == torch.int32
    assert eq(jbvh.leaves.index, tbvh.leaves.index)
    assert eq(jbvh.leaves.morton, tbvh.leaves.morton)
    assert all(eq(a, b) for a, b in zip(jbvh.leaves.volume.xs,
                                        tbvh.leaves.volume.xs))
    assert eq(jbvh.leaves.volume.r, tbvh.leaves.volume.r)
    assert all(eq(a, b) for a, b in zip(jbvh.nodes.los + jbvh.nodes.ups,
                                        tbvh.nodes.los + tbvh.nodes.ups))
    assert eq(jbvh.skips, tbvh.skips)
    assert jbvh.built_level == tbvh.built_level
    assert dataclass_fields(jbvh.tree) == dataclass_fields(tbvh.tree)


def dataclass_fields(tree):
    return (tree.levels, tree.real_leaves, tree.real_nodes,
            tree.virtual_leaves, tree.virtual_nodes)


def test_build_box_leaves_and_built_level():
    tri = triangles(700, 3)
    lo = np.minimum(np.minimum(tri[0], tri[1]), tri[2])
    up = np.maximum(np.maximum(tri[0], tri[1]), tri[2])
    jbvh = jb.build(jb.BBox(jnp.asarray(lo), jnp.asarray(up)), jb.BBox,
                    built_level=3)
    tbvh = tb.build(tb.BBox(torch.from_numpy(lo), torch.from_numpy(up)),
                    built_level=3)
    assert eq(jbvh.leaves.index, tbvh.leaves.index)
    assert all(eq(a, b) for a, b in zip(jbvh.nodes.los + jbvh.nodes.ups,
                                        tbvh.nodes.los + tbvh.nodes.ups))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 100, 1023, 1025])
def test_tree_algebra(n):
    jt = jb.ImplicitTree.from_num_leaves(n)
    tt = ImplicitTree.from_num_leaves(n)
    assert dataclass_fields(jt) == dataclass_fields(tt)
    assert np.array_equal(np.asarray(jb.compute_skips(jt)),
                          compute_skips(tt, device=CPU).numpy())
    for lvl in range(1, tt.levels + 1):
        assert jt.level_indices(lvl) == tt.level_indices(lvl)
    for k in range(1, 1 << tt.levels):
        assert jt.isvirtual(k) == tt.isvirtual(k)


def test_interop_round_trip(scene):
    """A JAX BVH flattened to numpy becomes the same port BVH as the port's
    own build."""
    _, js, ts = scene
    jbvh = jb.build(js, jb.BBox)
    d = {"leaf_kind": "sphere", "index": np.asarray(jbvh.leaves.index),
         "morton": np.asarray(jbvh.leaves.morton),
         "skips": np.asarray(jbvh.skips), "built_level": jbvh.built_level,
         "num_leaves": jbvh.num_leaves}
    for k in range(3):
        d[f"leaf_x{k}"] = np.asarray(jbvh.leaves.volume.xs[k])
        d[f"node_lo{k}"] = np.asarray(jbvh.nodes.los[k])
        d[f"node_up{k}"] = np.asarray(jbvh.nodes.ups[k])
    d["leaf_r"] = np.asarray(jbvh.leaves.volume.r)
    got = interop.bvh_from_numpy(d, CPU)
    want = tb.build(ts)
    for a, b in zip([got.leaves.index, got.leaves.morton, got.skips,
                     got.leaves.volume.r, *got.nodes.los, *got.nodes.ups],
                    [want.leaves.index, want.leaves.morton, want.skips,
                     want.leaves.volume.r, *want.nodes.los, *want.nodes.ups]):
        assert torch.equal(a, b)
    assert got.tree == want.tree and got.built_level == want.built_level


@pytest.mark.parametrize("n, built_level", [(1024, 1), (700, 1), (3000, 1),
                                            (700, 4), (1, 1), (2, 1),
                                            (3, 1)])
def test_build_bsphere_nodes_exact(n, built_level):
    """BSphere nodes bit-equal to the JAX package's: full and ragged
    levels (a copied last child), a ``built_level`` above 1 (zero-filled
    levels), and the smallest trees."""
    tri = triangles(n, 4)
    jbvh = jb.build(jax_spheres(tri), jb.BSphere, built_level=built_level)
    tbvh = tb.build(torch_spheres(tri), tb.BSphere, built_level=built_level)
    assert tbvh.node_kind is tb.BSphere and tbvh.leaf_kind is tb.BSphere
    assert tbvh.nodes.r.shape[0] == tbvh.tree.num_nodes
    assert all(eq(a, b) for a, b in zip(jbvh.nodes.xs, tbvh.nodes.xs))
    assert eq(jbvh.nodes.r, tbvh.nodes.r)
    if built_level > 1:
        lo, _ = tbvh.tree.level_indices(built_level)
        assert not tbvh.nodes.r[:lo - 1].any() and tbvh.nodes.r[lo - 1:].all()


def test_interop_carries_bsphere_nodes():
    tri = triangles(700, 4)
    jbvh = jb.build(jax_spheres(tri), jb.BSphere)
    d = {"leaf_kind": "sphere", "index": np.asarray(jbvh.leaves.index),
         "morton": np.asarray(jbvh.leaves.morton),
         "skips": np.asarray(jbvh.skips), "built_level": jbvh.built_level,
         "num_leaves": jbvh.num_leaves,
         "leaf_r": np.asarray(jbvh.leaves.volume.r),
         "node_r": np.asarray(jbvh.nodes.r)}
    for k in range(3):
        d[f"leaf_x{k}"] = np.asarray(jbvh.leaves.volume.xs[k])
        d[f"node_x{k}"] = np.asarray(jbvh.nodes.xs[k])
    got = interop.bvh_from_numpy(d, CPU)
    want = tb.build(torch_spheres(tri), tb.BSphere)
    assert got.node_kind is tb.BSphere
    for a, b in zip([*got.nodes.xs, got.nodes.r],
                    [*want.nodes.xs, want.nodes.r]):
        assert torch.equal(a, b)


def sphere_pairs(seed):
    """Two sphere batches that take every branch of the merges: far apart,
    overlapping, one inside the other either way, and identical."""
    rng = np.random.default_rng(seed)
    n = 4000
    xa = (rng.random((n, 3)) * 4).astype(np.float32)
    xb = (rng.random((n, 3)) * 4).astype(np.float32)
    ra = (rng.random(n) * 1.5 + 0.01).astype(np.float32)
    rb = (rng.random(n) * 1.5 + 0.01).astype(np.float32)
    ra[:500] *= 4
    rb[500:1000] *= 4
    xb[1000:1100], rb[1000:1100] = xa[1000:1100], ra[1000:1100]
    return (xa, ra), (xb, rb)


def both_volumes(x, r, box):
    if box:
        return (jb.BBox(jnp.asarray(x - r[:, None]), jnp.asarray(x + r[:, None])),
                tb.BBox(torch.from_numpy(x - r[:, None]),
                        torch.from_numpy(x + r[:, None])))
    return (jb.BSphere(jnp.asarray(x), jnp.asarray(r)),
            tb.BSphere(torch.from_numpy(x), torch.from_numpy(r)))


def volumes_eq(jv, tv):
    if isinstance(tv, tb.BSphere):
        return isinstance(jv, jb.BSphere) and eq(jv.r, tv.r) and \
            all(eq(a, b) for a, b in zip(jv.xs, tv.xs))
    return isinstance(jv, jb.BBox) and \
        all(eq(a, b) for a, b in zip(jv.los + jv.ups, tv.los + tv.ups))


def test_merges_and_conversions_exact():
    from implicitbvh_tpu import volumes as jv
    from implicitbvh_tpu_torch import volumes as tv
    (xa, ra), (xb, rb) = sphere_pairs(0)
    ja, ta = both_volumes(xa, ra, False)
    jb_, tb_ = both_volumes(xb, rb, False)
    jba, tba = both_volumes(xa, ra, True)
    jbb, tbb = both_volumes(xb, rb, True)
    assert volumes_eq(jv.merge(ja, jb_), tv.merge(ta, tb_))
    assert volumes_eq(jv.merge(jba, jbb), tv.merge(tba, tbb))
    assert volumes_eq(jv.bbox_of_two_bspheres(ja, jb_),
                      tv.bbox_of_two_bspheres(ta, tb_))
    for kind_j, kind_t in ((jb.BBox, tb.BBox), (jb.BSphere, tb.BSphere)):
        assert volumes_eq(jv.merge_into(kind_j, ja, jb_),
                          tv.merge_into(kind_t, ta, tb_))
        assert volumes_eq(jv.convert_volume(kind_j, ja),
                          tv.convert_volume(kind_t, ta))
    assert volumes_eq(jv.merge_into(jb.BBox, jba, jbb),
                      tv.merge_into(tb.BBox, tba, tbb))
    assert eq(jv.dist3sq(ja.xs, jb_.xs), tv.dist3sq(ta.xs, tb_.xs))
    with pytest.raises(TypeError):
        tv.merge(ta, tbb)
    with pytest.raises(TypeError):
        tv.convert_volume(tb.BSphere, tba)


def test_iscontact_exact():
    (xa, ra), (xb, rb) = sphere_pairs(1)
    ra, rb = ra * 0.3, rb * 0.3
    # touching spheres and boxes: the comparison is <=, >=
    xb[:200] = xa[:200]
    xb[:200, 0] += ra[:200] + rb[:200]
    for box_a in (False, True):
        for box_b in (False, True):
            ja, ta = both_volumes(xa, ra, box_a)
            jb_, tb_ = both_volumes(xb, rb, box_b)
            want = jb.iscontact(ja, jb_)
            got = tb.iscontact(ta, tb_)
            assert eq(want, got) and 0 < int(got.sum()) < got.numel()


def test_bbox_from_triangles_exact(scene):
    tri, _, _ = scene
    jv = jb.bbox_from_triangles(*[jnp.asarray(p) for p in tri])
    tv = tb.bbox_from_triangles(*[torch.from_numpy(p) for p in tri])
    assert volumes_eq(jv, tv)
    from implicitbvh_tpu_torch.volumes import from_triangles
    assert volumes_eq(jv, from_triangles(tb.BBox, *tri, device="cpu"))
    assert from_triangles(tb.BSphere, *tri, device="cpu").r.shape == (len(tri[0]),)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every ``.py`` of the port and ``chip_smoke.py`` import ``torch``,
    never ``jax`` and nothing of ``implicitbvh_tpu``."""
    import ast
    import pathlib
    root = pathlib.Path(tb.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "implicitbvh_tpu"), \
                    f"{path.name} imports {name}"


def test_unported_options_raise():
    """The options that used to raise now build: ``index_bits=64`` gives
    int64 indices and skips (tests/test_torch_index64.py holds every path
    against the JAX package); a Morton algorithm object of neither ported
    kind raises ``TypeError`` in both packages, and other index widths
    ``ValueError``.
    BFS (self and two trees) and DFS self-contact return the leaf-vs-tree
    walk's set (tests/test_torch_bfs.py and test_torch_dfs.py hold them
    against the JAX package)."""
    from implicitbvh_tpu_torch.morton import MortonAlgorithm
    tri = triangles(16, 0)
    ts = torch_spheres(tri)
    b64 = tb.build(ts, options=tb.BVHOptions(index_bits=64))
    assert b64.leaves.index.dtype == b64.skips.dtype == torch.int64
    assert tb.BVHOptions(index_bits=64).index_dtype == torch.int64
    assert torch.equal(b64.leaves.index, tb.build(ts).leaves.index.long())
    with pytest.raises(TypeError, match="morton algorithm"):
        tb.build(ts, options=tb.BVHOptions(morton=MortonAlgorithm()))

    # the JAX package reads ``bits`` before it dispatches, so its
    # algorithm object of another kind carries one
    @dataclasses.dataclass(frozen=True)
    class JaxOther(jax_morton.MortonAlgorithm):
        bits: int = 32

    @dataclasses.dataclass(frozen=True)
    class PortOther(MortonAlgorithm):
        bits: int = 32

    with pytest.raises(TypeError, match="morton algorithm"):
        tb.build(ts, options=tb.BVHOptions(morton=PortOther()))
    with pytest.raises(TypeError, match="morton algorithm"):
        jb.build(jax_spheres(tri), jb.BBox,
                 options=jb.BVHOptions(morton=JaxOther()))
    for bits in (16, 48):
        with pytest.raises(ValueError, match="index_bits"):
            tb.BVHOptions(index_bits=bits)
        with pytest.raises(ValueError, match="index_bits"):
            jb.BVHOptions(index_bits=bits)
    bvh = tb.build(ts)
    lvt_self = set(tb.traverse(bvh, tb.LVTTraversal()).contacts_list())
    for alg in (tb.BFSTraversal(), tb.DFSTraversal()):
        assert set(tb.traverse(bvh, alg).contacts_list()) == lvt_self
    assert set(tb.traverse(bvh, bvh, tb.BFSTraversal()).contacts_list()) == \
        set(tb.traverse(bvh, bvh, tb.LVTTraversal()).contacts_list())
    # DFS is self-contact only: two trees take the walk, as in the JAX
    # package (tests/test_torch_walks.py holds its result against it)
    dfs = tb.traverse(bvh, bvh, tb.DFSTraversal())
    assert set(dfs.contacts_list()) == \
        set(tb.traverse(bvh, bvh, tb.LVTTraversal()).contacts_list())
    with pytest.raises(TypeError):       # box leaves have no sphere nodes
        tb.build(tb.BBox(ts.xs, ts.xs), tb.BSphere)


IGNORED_OPTIONS = ("block_size", "num_threads", "min_mortons_per_thread",
                   "min_sorts_per_thread", "min_boundings_per_thread",
                   "min_traversals_per_thread")


@pytest.mark.parametrize("field", IGNORED_OPTIONS)
def test_ignored_options_validate_as_in_jax(field):
    """The reference's block size and threading knobs: the same defaults,
    accepted when positive and refused with ``ValueError`` otherwise, by
    both packages."""
    assert getattr(tb.BVHOptions(), field) == getattr(jb.BVHOptions(), field)
    for value in (0, -3):
        with pytest.raises(ValueError, match=field):
            jb.BVHOptions(**{field: value})
        with pytest.raises(ValueError, match=field):
            tb.BVHOptions(**{field: value})
    opts = tb.BVHOptions(**{field: 7})
    assert getattr(opts, field) == 7
    ts = torch_spheres(triangles(40, 3))
    assert torch.equal(tb.build(ts, options=opts).leaves.index,
                       tb.build(ts).leaves.index)


def test_center_and_bounding_volume_alias():
    tri = triangles(50, 4)
    js, ts = jax_spheres(tri), torch_spheres(tri)
    assert np.array_equal(np.asarray(jb.center(js)), tb.center(ts).numpy())
    jbox = jb.BBox(tuple(x - js.r for x in js.xs),
                   tuple(x + js.r for x in js.xs))
    tbox = tb.BBox(tuple(x - ts.r for x in ts.xs),
                   tuple(x + ts.r for x in ts.xs))
    assert tuple(tb.center(tbox).shape) == (50, 3)
    assert np.array_equal(np.asarray(jb.center(jbox)), tb.center(tbox).numpy())
    assert tb.BoundingVolume is tb.Leaves


def test_device_rules():
    """Torch tensors stay on their device; numpy inputs go to CUDA unless
    the CPU is asked for, and without a card that raises."""
    tri = triangles(64, 0)
    assert torch_spheres(tri).device == CPU
    assert tb.bsphere_from_triangles(*tri, device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.bsphere_from_triangles(*tri)
