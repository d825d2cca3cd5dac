"""The PyTorch port's build against the JAX package, on the CPU.

The same triangles, made by numpy from a seed, go through
``bsphere_from_triangles``, the Morton encoding, the stable Morton sort and
the BBox-node aggregation of both packages.  Every comparison is exact: the
port repeats the JAX package's float operations in the same order with the
same rounding (a float32 square root is taken correctly rounded), and the
rest is integer arithmetic, a stable sort and min/max.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import implicitbvh_tpu as jb
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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tb.BVHOptions(index_bits=64)
    ts = torch_spheres(triangles(16, 0))
    with pytest.raises(NotImplementedError):
        tb.build(ts, tb.BSphere)


def test_device_rules():
    """Torch tensors stay on their device; numpy inputs go to CUDA unless
    the CPU is asked for, and without a card that raises."""
    tri = triangles(64, 0)
    assert torch_spheres(tri).device == CPU
    assert tb.bsphere_from_triangles(*tri, device="cpu").device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tb.bsphere_from_triangles(*tri)
