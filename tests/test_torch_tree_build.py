"""The build's kernels T1 (``ops.tree_build``) and their plain version.

On the CPU: ``tree_build_plain`` against the build's definition, field by
field (a stable numpy argsort of the Morton codes, the leaves, indices and
codes in that order, each node the min / max of its real leaves' boxes,
zeros above ``built_level``, ``skips_np``), for sphere and box leaves, each
code width, computed and fixed extrema and every built level; a model of
T1c and T1d's decomposition (blocks of 2^K slots, K levels each in the
block, the levels above from the nodes written, the zero fill) against the
plain nodes; which inputs take T1, read from ``launches.tree_build`` with
the card's path stubbed; and the refusals.  ``gpu``-marked tests hold T1
against the plain version on the card bit for bit (sorted leaves, index,
codes, nodes, skips) over leaf counts, kinds, precisions, index widths,
code widths, extrema, built levels, coincident centres and NaN leaves,
under the sync check and in a CUDA graph replayed on new inputs, and the
tile and LVT queries of the cells' sizes on T1's BVH against the plain
BVH's; they skip without a card.  No JAX here.
"""

import importlib

import numpy as np
import pytest
import torch

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops, tracing
from implicitbvh_tpu_torch.morton import DefaultMortonAlgorithm
from implicitbvh_tpu_torch.volumes import center_coords

# the module (``ops.tree_build`` is its wrapper function)
tbm = importlib.import_module("implicitbvh_tpu_torch.ops.tree_build")

CPU = torch.device("cpu")


def leaves_of(kind, n, seed=0, dtype=torch.float32, device=CPU, side=10.0):
    """``n`` random spheres or boxes in a cube of ``side``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(3, n, generator=g, dtype=torch.float64) * side
    r = 0.05 + 0.2 * torch.rand(n, generator=g, dtype=torch.float64)
    x, r = x.to(dtype).to(device), r.to(dtype).to(device)
    if kind == "sphere":
        return tb.BSphere(tuple(x), r)
    return tb.BBox(tuple(x - r), tuple(x + r))


def options(bits=32, compute=True, index_bits=32):
    alg = DefaultMortonAlgorithm(bits=bits) if compute else \
        DefaultMortonAlgorithm(bits=bits, compute_extrema=False,
                               mins=(-1.0, -2.0, 0.5), maxs=(11.0, 9.0, 10.5))
    return tb.BVHOptions(morton=alg, index_bits=index_bits)


def boxes(volume):
    if isinstance(volume, tb.BSphere):
        return ([c - volume.r for c in volume.xs],
                [c + volume.r for c in volume.xs])
    return list(volume.los), list(volume.ups)


def definition(volume, index, tree, built, opts):
    """The build from its definition: ``(volume, index, morton, nodes,
    skips)`` as numpy arrays (volume and nodes as (F, n) / (6, nodes))."""
    centres = center_coords(volume)
    codes = tb.morton_encode(centres, opts.morton).numpy()
    order = np.argsort(codes, kind="stable")
    n = tree.real_leaves
    if index is None:
        index = np.arange(1, n + 1)
    fields = ([*volume.xs, volume.r] if isinstance(volume, tb.BSphere)
              else [*volume.los, *volume.ups])
    vol = np.stack([f.numpy()[order] for f in fields])
    lo, up = (np.stack([c.numpy()[order] for c in cs]) for cs in
              boxes(volume))
    nodes = np.zeros((6, max(tree.num_nodes, 0)), lo.dtype)
    counts, offsets = tbm.levels_of(tree)
    for lvl in range(max(built, 1), tree.levels):
        span = 1 << (tree.levels - lvl)
        for j in range(counts[lvl]):
            a, b = j * span, min((j + 1) * span, n)
            nodes[:3, offsets[lvl] + j] = lo[:, a:b].min(1)
            nodes[3:, offsets[lvl] + j] = up[:, a:b].max(1)
    return (vol, np.asarray(index)[order], codes[order], nodes,
            tree.skips_np(np.int64))


def plain(volume, index, built, opts, node_kind=tb.BBox):
    tree = tb.ImplicitTree.from_num_leaves(volume.batch_shape[0])
    return tree, tbm.tree_build_plain(volume, index, tree, built, node_kind,
                                      opts)


def as_numpy(out):
    vol, index, morton, nodes, skips = out
    f = tbm._fields(vol)
    return (torch.stack(f).cpu().numpy(), index.cpu().numpy(),
            morton.cpu().numpy(), torch.stack(tbm._fields(nodes)).cpu()
            .numpy(), skips.cpu().numpy())


@pytest.mark.parametrize("kind", ["sphere", "box"])
@pytest.mark.parametrize("bits,compute", [(16, True), (32, True), (64, True),
                                          (32, False)])
def test_plain_version_is_the_definition(kind, bits, compute):
    opts = options(bits, compute)
    for n in (1, 2, 3, 5, 100, 1025):
        volume = leaves_of(kind, n, seed=n)
        tree = tb.ImplicitTree.from_num_leaves(n)
        for built in sorted({1, max(1, tree.levels // 2), tree.levels}):
            _, got = plain(volume, None, built, opts)
            want = definition(volume, None, tree, built, opts)
            for name, g, w in zip(("volume", "index", "morton", "nodes",
                                   "skips"), as_numpy(got), want):
                assert g.shape == w.shape, (name, n, built)
                assert np.array_equal(g, w), (name, n, built)
            assert got[1].dtype == torch.int32 and got[4].dtype == torch.int32


def test_plain_version_is_build():
    """``build`` runs the plain version on the CPU: its BVH holds the plain
    version's outputs, user indices included."""
    volume = leaves_of("sphere", 777, seed=3)
    custom = torch.arange(777, dtype=torch.int64) * 7 - 100
    opts = tb.BVHOptions(index_bits=64)
    bvh = tb.build(volume, built_level=3, options=opts, indices=custom)
    _, want = plain(volume, custom, 3, opts)
    got = (bvh.leaves.volume, bvh.leaves.index, bvh.leaves.morton,
           bvh.nodes, bvh.skips)
    for g, w in zip(as_numpy(got), as_numpy(want)):
        assert np.array_equal(g, w)


def min_nan(a, b):
    return torch.where(torch.isnan(a) | (a < b), a, b)


def max_nan(a, b):
    return torch.where(torch.isnan(a) | (a > b), a, b)


def model_nodes(lo, up, tree, built, K):
    """T1c and T1d's decomposition on sorted leaf boxes ((3, n) each): blocks
    of 2^K slots padded with +-max, K levels each, written where real and
    built; the levels above from the written level below; zeros above
    ``built``.  Unwritten nodes stay NaN."""
    n, levels = tree.real_leaves, tree.levels
    counts, offsets = tbm.levels_of(tree)
    n_nodes = max(tree.num_nodes, 0)
    big = torch.finfo(lo.dtype).max
    nodes = torch.full((6, n_nodes), float("nan"), dtype=lo.dtype)
    nodes[:, :offsets[built] if built < levels else n_nodes] = 0
    S = 1 << K
    slots = -(-n // S) * S          # the blocks' slots, pairs never cross
    box = torch.cat([torch.full((3, slots), big, dtype=lo.dtype),
                     torch.full((3, slots), -big, dtype=lo.dtype)])
    box[:3, :n], box[3:, :n] = lo, up
    for d in range(1, K + 1):
        box = torch.cat([min_nan(box[:3, 0::2], box[:3, 1::2]),
                         max_nan(box[3:, 0::2], box[3:, 1::2])])
        lvl = levels - d
        if lvl >= built:
            at = offsets[lvl]
            nodes[:, at:at + counts[lvl]] = box[:, :counts[lvl]]
    pad = torch.tensor([big] * 3 + [-big] * 3, dtype=lo.dtype)[:, None]
    for lvl in range(levels - K - 1, built - 1, -1):
        below = nodes[:, offsets[lvl + 1]:offsets[lvl + 1] + counts[lvl + 1]]
        if counts[lvl + 1] % 2:
            below = torch.cat([below, pad], 1)
        at = offsets[lvl]
        nodes[:3, at:at + counts[lvl]] = min_nan(below[:3, 0::2],
                                                 below[:3, 1::2])
        nodes[3:, at:at + counts[lvl]] = max_nan(below[3:, 0::2],
                                                 below[3:, 1::2])
    return nodes


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 1023, 1024, 1025, 3001])
def test_model_of_the_kernels_decomposition(n):
    """Every K the builder may pick up to the tree's height, every built
    level: the blocks' levels and the top levels write each node once, and
    the nodes equal the plain version's."""
    volume = leaves_of("sphere", n, seed=n, dtype=torch.float64)
    tree = tb.ImplicitTree.from_num_leaves(n)
    for built in range(1, tree.levels + 1):
        _, (vol, _, _, nodes, _) = plain(volume, None, built, options())
        lo, up = (torch.stack(c) for c in boxes(vol))
        want = torch.stack(tbm._fields(nodes))
        # the builder's K is at least 1 above a one-leaf tree
        for K in sorted({1, 3, tree.levels - 1,
                         tbm.tile_log2(torch.float64, tree)}):
            if not min(1, tree.levels - 1) <= K <= tree.levels - 1:
                continue
            got = model_nodes(lo, up, tree, built, K)
            assert torch.equal(got, want), (n, built, K)


@pytest.fixture
def stub_card(monkeypatch):
    """The card's path stubbed on the CPU: inputs that T1 takes count a
    launch and get the plain version's outputs."""
    def card(volume, index, tree, built, opts):
        tracing.count("launches.tree_build")
        return tbm.tree_build_plain(volume, index, tree, built, tb.BBox,
                                    opts)

    monkeypatch.setattr(tbm, "_on_card", lambda t: True)
    monkeypatch.setattr(tbm, "_tree_build_cuda", card)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _ext():
    return tb.BVHOptions(morton=tb.ExtendedMortonAlgorithm(bits=32))


DISPATCH = {
    # name: (leaves, node kind, options, takes T1)
    "sphere_f32": (lambda: leaves_of("sphere", 50), tb.BBox, options(), 1),
    "box_f64": (lambda: leaves_of("box", 50, dtype=torch.float64), tb.BBox,
                options(), 1),
    "bits16_fixed": (lambda: leaves_of("sphere", 50), tb.BBox,
                     options(16, False), 1),
    "bits64_index64": (lambda: leaves_of("box", 50), tb.BBox,
                       options(64, True, 64), 1),
    "one_leaf": (lambda: leaves_of("sphere", 1), tb.BBox, options(), 1),
    "sphere_nodes": (lambda: leaves_of("sphere", 50), tb.BSphere, options(),
                     0),
    "extended": (lambda: leaves_of("sphere", 50), tb.BBox, _ext(), 0),
    "float16": (lambda: leaves_of("sphere", 50, dtype=torch.float16),
                tb.BBox, options(), 0),
    "bfloat16": (lambda: leaves_of("box", 50, dtype=torch.bfloat16),
                 tb.BBox, options(), 0),
    "mixed_dtypes": (lambda: tb.BSphere(
        tuple(torch.rand(3, 50)), torch.rand(50, dtype=torch.float64)),
        tb.BBox, options(), 0),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_which_inputs_take_the_kernels(stub_card, name):
    make, node_kind, opts, takes = DISPATCH[name]
    volume = make()
    bvh = tb.build(volume, node_kind, options=opts)
    assert ops.launch_count(ops.tree_build) == takes, name
    assert tracing.counter("calls.build") >= 1
    assert bvh.num_leaves == volume.batch_shape[0]


def test_strided_fields_and_user_indices_take_the_kernels(stub_card):
    """(N, 3) arrays give strided fields, ``Leaves`` give user indices: both
    take T1 (its launcher reads strides)."""
    xs = torch.rand(40, 3)
    leaves = tb.Leaves(tb.BSphere(xs, torch.full((40,), 0.1)),
                       torch.arange(40) + 9, torch.zeros(40, dtype=torch.int64))
    assert leaves.volume.xs[0].stride(0) == 3
    bvh = tb.build(leaves)
    assert ops.launch_count(ops.tree_build) == 1
    assert sorted(bvh.leaves.index.tolist()) == list(range(9, 49))


def test_the_cpu_takes_the_plain_version():
    ops.reset_launch_counts()
    bvh = tb.build(leaves_of("sphere", 300))
    assert ops.launch_count(ops.tree_build) == 0
    assert tb.traverse(bvh).num_contacts >= 0


def test_refusals(stub_card):
    volume = leaves_of("sphere", 20)
    tree = tb.ImplicitTree.from_num_leaves(20)
    with pytest.raises(ValueError, match="an index per leaf"):
        ops.tree_build(volume, torch.arange(19, dtype=torch.int32), tree, 1,
                       tb.BBox, options())
    with pytest.raises(ValueError, match="an index per leaf"):
        tb.build(volume, indices=torch.arange(21))
    with pytest.raises(TypeError, match="index must be torch.int32"):
        ops.tree_build(volume, torch.arange(20), tree, 1, tb.BBox,
                       options())
    with pytest.raises(ValueError, match="the tree has 21 leaves"):
        ops.tree_build(volume, None, tb.ImplicitTree.from_num_leaves(21), 1,
                       tb.BBox, options())
    for built in (0, tree.levels + 1):
        with pytest.raises(ValueError, match="built_level"):
            ops.tree_build(volume, None, tree, built, tb.BBox, options())
    with pytest.raises(TypeError, match="unknown node kind"):
        tb.build(volume, int)
    with pytest.raises(TypeError, match="cannot convert"):
        tb.build(leaves_of("box", 20), tb.BSphere)

    class Other(tb.MortonAlgorithm):
        pass

    with pytest.raises(TypeError, match="unsupported morton algorithm"):
        tb.build(volume, options=tb.BVHOptions(morton=Other()))
    assert ops.launch_count(ops.tree_build) == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def card_equals_plain(volume, built=1, opts=None, index=None,
                      node_kind=tb.BBox):
    """T1 against the plain version on the same card inputs, bit for bit;
    one launch."""
    opts = opts or options()
    tree = tb.ImplicitTree.from_num_leaves(volume.batch_shape[0])
    before = ops.launch_count(ops.tree_build)
    got = ops.tree_build(volume, index, tree, built, node_kind, opts)
    torch.cuda.synchronize()
    assert ops.launch_count(ops.tree_build) == before + 1
    want = tbm.tree_build_plain(volume, index, tree, built, node_kind, opts)
    flat = [lambda o: tbm._fields(o[0]), lambda o: (o[1],),
            lambda o: (o[2],), lambda o: tbm._fields(o[3]),
            lambda o: (o[4],)]
    for name, pick in zip(("volume", "index", "morton", "nodes", "skips"),
                          flat):
        for g, w in zip(pick(got), pick(want)):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(_bits(g), _bits(w)), name
    return got


SIZES = [1, 2, 3, 5, 1023, 1024, 1025, 249_882, 1 << 20, 1 << 22]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere", "box"])
@pytest.mark.parametrize("n", SIZES)
def test_card_equals_plain_at_leaf_counts(cuda, n, kind):
    card_equals_plain(leaves_of(kind, n, seed=n, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [True, False])
@pytest.mark.parametrize("bits", [16, 32, 64])
@pytest.mark.parametrize("index_bits", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_card_equals_plain_over_kinds(cuda, kind, dtype, index_bits, bits,
                                      compute):
    opts = options(bits, compute, index_bits)
    for n in (1025, 249_882):
        volume = leaves_of(kind, n, seed=bits + n,
                           dtype=getattr(torch, dtype), device=cuda)
        card_equals_plain(volume, opts=opts)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 1025, 249_882, 1 << 20])
def test_card_equals_plain_at_built_levels(cuda, n):
    tree = tb.ImplicitTree.from_num_leaves(n)
    for dtype in (torch.float32, torch.float64):
        volume = leaves_of("sphere", n, seed=7, dtype=dtype, device=cuda)
        for built in sorted({1, 2, tree.levels // 2, tree.levels - 11,
                             tree.levels - 10, tree.levels - 1,
                             tree.levels}):
            if 1 <= built <= tree.levels:
                card_equals_plain(volume, built=built)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_card_equals_plain_on_edge_scenes(cuda, kind):
    """Coincident centres (every code equal), a scene on one plane, NaN
    leaves (NaN extrema and NaN nodes), infinite coordinates, user indices
    and strided fields."""
    n = 5000
    same = tb.BSphere(tuple(torch.full((3, n), 2.5, device=cuda)),
                      torch.full((n,), 0.5, device=cuda))
    flat = leaves_of("sphere", n, device=cuda)
    flat = tb.BSphere((flat.xs[0], flat.xs[1], torch.zeros_like(flat.r)),
                      flat.r)
    scenes = [same, flat]
    for bad in (float("nan"), float("inf")):
        v = leaves_of("sphere", n, seed=2, device=cuda)
        x0 = v.xs[0].clone()
        x0[[0, 17, 2500, n - 1]] = bad
        scenes.append(tb.BSphere((x0, v.xs[1], v.xs[2]), v.r))
    if kind == "box":
        scenes = [tb.BBox(*boxes(v)) for v in scenes]
    for v in scenes:
        for compute in (True, False):
            card_equals_plain(v, opts=options(32, compute))
    xs = torch.rand(n, 3, device=cuda) * 5
    strided = tb.BSphere(xs, torch.full((n,), 0.1, device=cuda))
    if kind == "box":
        strided = tb.BBox(xs - 0.1, xs + 0.1)
    custom = (torch.arange(n, device=cuda) * 3 - 7).int()
    card_equals_plain(strided, index=custom[::1])
    card_equals_plain(strided, index=torch.arange(2 * n, device=cuda)[::2],
                      opts=options(32, True, 64))


@pytest.mark.gpu
def test_card_build_makes_no_host_sync(cuda):
    volume = leaves_of("sphere", 1 << 20, device=cuda)
    box = leaves_of("box", 249_882, dtype=torch.float64, device=cuda)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v, opts in ((volume, options()), (box, options(64, False, 64))):
            tb.build(v, options=opts)
            tb.build(v, built_level=3, options=opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ops.launch_count(ops.tree_build) == 4


@pytest.mark.gpu
def test_card_build_captured_and_replayed_on_new_inputs(cuda):
    n = 249_882
    xs = leaves_of("sphere", n, seed=1, device=cuda)
    x = torch.stack(xs.xs).clone()
    r = xs.r.clone()

    def run():
        bvh = tb.build(tb.BSphere(tuple(x), r))
        return (*tbm._fields(bvh.leaves.volume), bvh.leaves.index,
                bvh.leaves.morton, *tbm._fields(bvh.nodes), bvh.skips)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    ops.reset_launch_counts()
    with torch.cuda.graph(g):
        captured = run()
    assert ops.launch_count(ops.tree_build) == 1
    for seed in (2, 3):
        new = leaves_of("sphere", n, seed=seed, device=cuda)
        x.copy_(torch.stack(new.xs))
        r.copy_(new.r)
        g.replay()
        want = run()
        torch.cuda.synchronize()
        for a, b in zip(captured, want):
            assert torch.equal(_bits(a), _bits(b))
    del g


def _plain_bvh(volume, opts=None):
    opts = opts or tb.BVHOptions()
    tree = tb.ImplicitTree.from_num_leaves(volume.batch_shape[0])
    vol, index, morton, nodes, skips = tbm.tree_build_plain(
        volume, None, tree, 1, tb.BBox, opts)
    return tb.BVH(skips=skips, nodes=nodes,
                  leaves=tb.Leaves(vol, index, morton), built_level=1,
                  tree=tree)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [249_882, 1 << 20])
def test_card_queries_on_the_kernels_bvh(cuda, n):
    """The fixed tile query and the LVT walk on T1's BVH return the plain
    BVH's rows, in order."""
    g = torch.Generator().manual_seed(n)
    side = round(n ** (1 / 3))
    x = (torch.rand(3, n, generator=g) * side).to(cuda)
    r = (0.1 + 0.1 * torch.rand(n, generator=g)).to(cuda)
    volume = tb.BSphere(tuple(x), r)
    bvh, ref = tb.build(volume), _plain_bvh(volume)
    for got, want in ((tb.traverse_tiles_fixed(
            bvh, 1 << 17, alg=tb.TileTraversal(row_cap=4, pair_cap=32)),
            tb.traverse_tiles_fixed(
            ref, 1 << 17, alg=tb.TileTraversal(row_cap=4, pair_cap=32))),
            (tb.traverse_lvt_single_fixed(bvh, 1 << 17),
             tb.traverse_lvt_single_fixed(ref, 1 << 17))):
        assert int(got[0]) == int(want[0]) and int(got[0]) > 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)
