"""The port's sync-free build and its step, ``implicitbvh_tpu_torch.entry``,
on the CPU against the JAX package.

The JAX package's build traces into one program with the traversal: its
tree shape and skip table are static, and the extended order's schedule
runs on traced scalars.  The port's build holds the same contract: it
reads nothing back from the device and copies nothing from the host, so a
CUDA graph can capture it with the traversal.  Held here: the skip table
made on the device equals ``skips_np`` and the JAX package's
``compute_skips``; a guard that raises on every Python-level read of a
tensor's value and on every tensor made from host data finds none in
``build`` for any option; the extended order's device schedule equals the
greedy loop on degenerate ranges (its fallback); the extended codes equal
the JAX package's on the scenes that reach that fallback; and the port's
``entry()`` step equals the JAX package's ``__graft_entry__.entry()``
step.  Tolerance: exact.  One ``gpu`` case captures the step in a CUDA
graph and replays it on new spheres against the eager step.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import morton as jm
    import __graft_entry__ as jentry
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import entry as tentry
from implicitbvh_tpu_torch import morton as tm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_compute_skips_on_device(dtype):
    """Every leaf count 1..4,096 and a few large ones: the table made from
    the tree's integers equals ``skips_np`` and the JAX package's."""
    for n in [*range(1, 4097), (1 << 20) - 1, 1 << 20, (1 << 20) + 1,
              1 << 29]:
        tree = tb.ImplicitTree.from_num_leaves(n)
        got = tb.compute_skips(tree, getattr(torch, dtype), CPU)
        assert got.dtype == getattr(torch, dtype)
        want = jb.compute_skips(jb.ImplicitTree.from_num_leaves(n),
                                getattr(jnp, dtype))
        assert np.array_equal(got.numpy(), tree.skips_np(dtype)), n
        assert np.array_equal(got.numpy(), np.asarray(want)), n


@contextlib.contextmanager
def no_host_traffic():
    """Raise on every Python-level read of a tensor's value (``item``,
    ``tolist``, ``numpy``, ``cpu``, ``bool``/``int``/``float``/``index``
    conversions) and on every tensor made from host data (``torch.tensor``,
    ``as_tensor``, ``from_numpy`` of anything but a tensor): on a CUDA
    tensor each is a host sync or a host-to-device copy."""
    def refuse(name):
        def call(*args, **kw):
            raise AssertionError(f"host traffic: {name}")
        return call

    def tensors_only(name, fn):
        def call(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"host data: torch.{name}")
            return fn(data, *args, **kw)
        return call

    saved = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        saved.append((torch.Tensor, name, getattr(torch.Tensor, name)))
        setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    for name in ("tensor", "as_tensor", "from_numpy"):
        fn = getattr(torch, name)
        saved.append((torch, name, fn))
        setattr(torch, name, tensors_only(name, fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def leaves(n, seed, stretch=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)).astype(np.float32) * np.float32(n ** (1 / 3))
    c *= np.asarray(stretch, np.float32)
    rs = (rng.random(n) * 0.5 + 0.05).astype(np.float32)
    return c, rs


def guarded_options():
    ext = tb.ExtendedMortonAlgorithm
    fixed = dict(compute_extrema=False, mins=(-1.0, -2.0, -0.5),
                 maxs=(60.0, 10.5, 3.25))
    opts = {f"default {b}": tb.BVHOptions(
        morton=tb.DefaultMortonAlgorithm(bits=b)) for b in (16, 32, 64)}
    opts["default fixed bounds"] = tb.BVHOptions(
        morton=tb.DefaultMortonAlgorithm(bits=32, **fixed))
    for b in (16, 32, 64):
        for name, kw in (("", {}), (" no size bits", dict(size_interval=0)),
                         (" no sqrt", dict(use_sqrt_size=0)),
                         (" fixed bounds", fixed)):
            opts[f"extended {b}{name}"] = tb.BVHOptions(morton=ext(bits=b,
                                                                   **kw))
    opts["index_bits 64"] = tb.BVHOptions(index_bits=64)
    opts["extended 64, index_bits 64"] = tb.BVHOptions(
        index_bits=64, morton=ext(bits=64))
    return opts


@pytest.mark.parametrize("node_kind", ["BBox", "BSphere"])
def test_build_makes_no_host_traffic(node_kind):
    """``build`` on tensors made before the guard, for every Morton order,
    width and bound, BBox and BSphere nodes, sphere and box leaves, 32- and
    64-bit indices: no read of a value, no tensor from host data."""
    c, rs = leaves(700, 4, stretch=(4.0, 1.0, 0.5))
    vols = [tb.BSphere(c, rs, device=CPU),
            tb.BBox(c - rs[:, None], c + rs[:, None], device=CPU)]
    kind = getattr(tb, node_kind)
    for name, opts in guarded_options().items():
        for vol in vols[:1] if kind is tb.BSphere else vols:
            want = tb.build(vol, kind, options=opts)
            with no_host_traffic():
                got = tb.build(vol, kind, options=opts)
            assert torch.equal(got.leaves.morton, want.leaves.morton), name
            assert torch.equal(got.skips, want.skips), name
            assert got.skips.dtype == opts.index_dtype, name


def test_guard_catches_host_traffic():
    """The guard raises on what the build used to do."""
    t = torch.arange(3.0)
    for bad in (lambda: t.cpu(), lambda: float(t[0]), lambda: t.numpy(),
                lambda: torch.as_tensor(np.arange(3)),
                lambda: torch.tensor([1, 2]), lambda: bool(t[0] > 0)):
        with no_host_traffic(), pytest.raises(AssertionError,
                                              match="host"):
            bad()
    with no_host_traffic():
        assert torch.as_tensor(t) is t


# range values that reach the schedule's fallback: zero, infinite, NaN,
# below the smallest normal (flushed), a length that flushes after a few
# halvings, and the largest below 2^-125, whose first halving rounds up to
# the smallest normal
SPECIAL = [0.0, 7.0, 1e-37, 3e-39, np.inf, np.nan,
           float(np.float32((2 - 2 ** -23) * 2 ** -126))]
SIZE_OPTS = [{}, dict(size_interval=0), dict(use_sqrt_size=0),
             dict(size_interval=5, size_budget=3, use_sqrt_size=1),
             dict(size_interval=1, size_budget=9)]


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_device_schedule_equals_the_greedy_loop(bits):
    """``_schedule`` (a sort and three fallback passes, no loop over the
    bits) against ``_extended_schedule`` (the JAX package's greedy loop):
    each bit's axis or size slot, its shift, the counts."""
    rng = np.random.default_rng(bits)
    cases = list(itertools.product(SPECIAL, repeat=3))
    cases += [tuple(rng.random(3) * 10.0 ** rng.integers(-40, 5, 3))
              for _ in range(60)]
    algs = [tm.ExtendedMortonAlgorithm(bits=bits, **kw) for kw in SIZE_OPTS]
    for ranges in cases:
        r32 = np.asarray(ranges, np.float32)
        for alg in algs:
            axes, counts = tm._extended_schedule(r32, alg)
            src, shift, got = tm._schedule(torch.from_numpy(r32), alg)
            assert ["size" if s == 3 else s for s in src.tolist()] == axes, \
                (ranges, alg)
            assert got.tolist() == counts.tolist(), (ranges, alg)
            rem = [*counts.tolist(), len(alg.size_slots)]
            want = []
            for ax in axes:
                k = 3 if ax == "size" else ax
                rem[k] -= 1
                want.append(rem[k])
            assert shift.tolist() == want, (ranges, alg)


def fallback_scenes(n=400, seed=11):
    """Centres on a plane (z = 0: a range of twice the smallest normal,
    whose lengths flush after two halvings), all at the origin, and with
    fixed bounds: a flat axis (range 0), every axis flat, and one axis
    whose range is float32's epsilon."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)).astype(np.float32) * np.float32(7.0)
    flat = c.copy()
    flat[:, 2] = 0
    origin = np.zeros_like(c)
    eps = float(np.finfo(np.float32).eps)
    return [
        ("flat z", flat, {}),
        ("all at the origin", origin, {}),
        ("fixed, flat z", flat, dict(compute_extrema=False,
                                     mins=(0.0, 0.0, 0.0),
                                     maxs=(7.0, 7.0, 0.0))),
        ("fixed, all flat", origin, dict(compute_extrema=False,
                                         mins=(0.0, 0.0, 0.0),
                                         maxs=(0.0, 0.0, 0.0))),
        ("fixed, z range eps", flat, dict(compute_extrema=False,
                                          mins=(0.0, 0.0, 0.0),
                                          maxs=(7.0, 7.0, eps))),
    ], (rng.random(n) * 0.5 + 0.05).astype(np.float32)


@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_extended_codes_on_fallback_scenes_match_jax(kind):
    scenes, rs = fallback_scenes()
    for name, c, fixed in scenes:
        if kind == "box":
            lo, up = c - rs[:, None], c + rs[:, None] * np.float32(1.3)
            jv = jb.BBox(jnp.asarray(lo), jnp.asarray(up))
            tv = tb.BBox(lo, up, device=CPU)
        else:
            jv = jb.BSphere(jnp.asarray(c), jnp.asarray(rs))
            tv = tb.BSphere(c, rs, device=CPU)
        for kw in SIZE_OPTS[:3]:
            ja = jm.ExtendedMortonAlgorithm(bits=64, **fixed, **kw)
            ta = tm.ExtendedMortonAlgorithm(bits=64, **fixed, **kw)
            want = np.asarray(jm.morton_encode_extended(jv, ja))
            got = tm.morton_encode_extended(tv, ta).numpy()
            assert np.array_equal(want.view(np.int64), got), (name, kw)


def test_example_spheres_bit_equal():
    for n, seed in ((8192, 0), (1000, 3)):
        jx, jr = jentry._example_spheres(n, seed)
        tx, tr = tentry.example_spheres(n, seed, device=CPU)
        assert tx.dtype == tr.dtype == torch.float32
        assert np.array_equal(np.asarray(jx).view(np.int32),
                              tx.numpy().view(np.int32))
        assert np.array_equal(np.asarray(jr).view(np.int32),
                              tr.numpy().view(np.int32))


def contact_set(total, contacts):
    return sorted(map(tuple, np.asarray(contacts)[:int(total)].tolist()))


def test_entry_step_matches_jax():
    """The port's step on the CPU at 1,024 spheres against the JAX
    package's jitted step (its Pallas kernels in interpret mode): the
    total (overflow folded in as -2^30) and the sorted contact set."""
    step, (x, r) = tentry.entry(device=CPU)
    assert x.shape == (8192, 3) and r.shape == (8192,)
    assert x.device == CPU
    jstep, _ = jentry.entry()
    jtotal, jcon = jax.jit(jstep)(*jentry._example_spheres(1024))
    total, contacts = step(*tentry.example_spheres(1024, device=CPU))
    assert total.dtype == torch.int32 and contacts.shape == (1 << 16, 2)
    assert int(total) == int(jtotal) > 0
    assert contact_set(total, contacts) == contact_set(jtotal, jcon)


@pytest.mark.gpu
def test_entry_step_captured_on_card():
    """The step captured in a CUDA graph at 1,024 spheres: a replay on the
    captured spheres and one on a second draw copied into them each equal
    the eager step on the same spheres."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step = tentry.step
    x, r = tentry.example_spheres(1024, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(x, r)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        total, contacts = step(x, r)
    for seed in (0, 1):
        nx, nr = tentry.example_spheres(1024, seed=seed, device="cuda")
        x.copy_(nx)
        r.copy_(nr)
        graph.replay()
        got = (int(total), contact_set(total, contacts.cpu()))
        want_t, want_c = step(nx, nr)
        assert got == (int(want_t), contact_set(want_t, want_c.cpu()))
        assert got[0] > 0
