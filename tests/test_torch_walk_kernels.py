"""The walk kernels W1 (``csrc/walk.cu``) and W2 (``csrc/dfs.cu``) against
the JAX package's device loops, on the CPU.

The CPU has no nvcc and no card, so the kernels' algorithm is held here
through a sequential emulation in numpy: one lane walked to its end before
the next, step for step as the kernels do (the same level, virtual, dedup,
climb and push rules, the same float32 operations rounded one at a time,
the NaN rule ``(x < y) ? x : y``), over the records the wrappers pack
(``ops.walk.pack_walk`` and ``pack_dfs``, themselves held bit for bit
against the volumes' fields).  Its per-lane counts, the offsets and the
whole written buffer in order must equal the JAX package's
``stackless_walk`` (through ``lvt_*`` and ``rays_*``) and
``dfs_single_fixed`` exactly, as must the port's routed walk on CPU
tensors (the plain loops).  Tolerance: exact.  The ``gpu`` cases hold the
kernels against their plain versions on the card and replay one captured
``traverse_lvt_pair_fixed`` on new inputs.
"""

import numpy as np
import pytest
import torch

try:  # the reference; a machine that runs only the port has no JAX
    import jax.numpy as jnp
    import implicitbvh_tpu as jb
    from implicitbvh_tpu import raytrace as jray
    from implicitbvh_tpu.traverse import dfs as jdfs
    from implicitbvh_tpu.traverse import lvt as jlvt
except ImportError:
    jb = None

import implicitbvh_tpu_torch as tb
from implicitbvh_tpu_torch import ops
from implicitbvh_tpu_torch import raytrace as tray
from implicitbvh_tpu_torch.ops import walk as owalk
from implicitbvh_tpu_torch.traverse import dfs as tdfs
from implicitbvh_tpu_torch.traverse import walk as twalk

F = np.float32
SPHERE, BOX, RAY = 0, 1, 2


@pytest.fixture(autouse=True)
def reference(request):
    if jb is None and "gpu" not in request.keywords:
        pytest.skip("needs JAX and the implicitbvh_tpu package")


# --------------------------------------------------------------------------
# Scenes: the same numpy draws in both packages, the port's BVHs carried
# across from the JAX package's
# --------------------------------------------------------------------------

def spheres(n, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 3), dtype=np.float32) * F(scale)
    rs = (rng.random(n, dtype=np.float32) * F(0.4) + F(0.05)).astype(F)
    return xs, rs


def to_port(jbvh):
    from test_torch_pair import to_port as carry
    return carry(jbvh)


def jax_bvh(n, seed, box=False, node_kind="box", bits=32, scale=5.0):
    xs, rs = spheres(n, seed, scale)
    if box:
        vol = jb.BBox(jnp.asarray(xs - rs[:, None]),
                      jnp.asarray(xs + rs[:, None]))
    else:
        vol = jb.BSphere(jnp.asarray(xs), jnp.asarray(rs))
    kind = jb.BSphere if node_kind == "sphere" else jb.BBox
    return jb.build(vol, kind, options=jb.BVHOptions(index_bits=bits))


def rays(k, seed, scale=5.0):
    """(3, k) float32 rays; some direction components are zero, and some
    rays start in a coordinate plane of the scene."""
    rng = np.random.default_rng(seed)
    p = (rng.random((3, k)) * scale).astype(F)
    d = (rng.random((3, k)) - 0.5).astype(F)
    d[0, :k // 4] = 0.0
    d[1, k // 8:k // 3] = 0.0
    p[2, :k // 6] = F(0.0)
    return p, d


def dedup_of(tbvh):
    n, levels = tbvh.num_leaves, tbvh.tree.levels
    return torch.arange(1, n + 1, dtype=tbvh.skips.dtype) + \
        (1 << (levels - 1)) - 1


# --------------------------------------------------------------------------
# The emulation: walk.cu and dfs.cu, one lane at a time
# --------------------------------------------------------------------------

def rows(t):
    return [list(r) for r in t.numpy()]


def box_of_sphere(s):
    return [s[0] - s[3], s[1] - s[3], s[2] - s[3],
            s[0] + s[3], s[1] + s[3], s[2] + s[3]]


def sphere_hit(a, b):
    dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    rr = a[3] + b[3]
    return (dx * dx + dy * dy) + dz * dz <= rr * rr


def box_hit(a, b):
    return (a[3] >= b[0]) & (a[0] <= b[3]) & (a[4] >= b[1]) & \
        (a[1] <= b[4]) & (a[5] >= b[2]) & (a[2] <= b[5])


def min2(x, y):
    return x if x < y else y


def max2(x, y):
    return x if x > y else y


def ray_box_hit(a, b):
    tmin = tmax = None
    for k in range(3):
        t1 = (b[k] - a[k]) * a[3 + k]
        t2 = (b[3 + k] - a[k]) * a[3 + k]
        lo, hi = min2(t1, t2), max2(t1, t2)
        tmin = lo if k == 0 else max2(tmin, lo)
        tmax = hi if k == 0 else min2(tmax, hi)
    return (tmin <= tmax) & (tmax >= 0)


def ray_sphere_hit(a, b):
    po = [a[k] - b[k] for k in range(3)]
    qb = F(2) * ((po[0] * a[3] + po[1] * a[4]) + po[2] * a[5])
    qc = ((po[0] * po[0] + po[1] * po[1]) + po[2] * po[2]) - b[3] * b[3]
    disc = qb * qb - (F(4) * a[6]) * qc
    return (disc >= 0) & ((qb <= 0) | (qc <= 0))


def volumes_hit(ka, a, kb, b):
    if ka == SPHERE and kb == SPHERE:
        return sphere_hit(a, b)
    return box_hit(box_of_sphere(a) if ka == SPHERE else a,
                   box_of_sphere(b) if kb == SPHERE else b)


def volume(rec, kind):
    return rec[:4] if kind == SPHERE else rec[:6]


def emulate_walk(a: owalk.WalkArgs):
    """W1 on the packed arguments: returns (counts, out) as int64 arrays."""
    nodes, leaves, lanes = rows(a.nodes), rows(a.leaves), rows(a.lanes)
    leaf_index, skips = a.leaf_index.tolist(), a.skips.tolist()
    lane_index = None if a.lane_index is None else a.lane_index.tolist()
    dedup = None if a.dedup is None else a.dedup.tolist()
    offsets = None if a.offsets is None else a.offsets.tolist()
    counts = np.zeros(a.K, np.int64)
    out = np.zeros((a.capacity, 2), np.int64)
    leaf_base = (1 << (a.levels - 1)) - 1
    for k in range(a.K):
        if a.lane_kind == RAY:
            r = lanes[k]
            p, d = r[:3], r[3:6]
            q_box = p + [F(1) / c for c in d]
            q_sph = p + d + [(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]]
            own = a.ray_offset + k + 1

            def node_hit(n):
                return ray_box_hit(q_box, n) if a.node_kind == BOX \
                    else ray_sphere_hit(q_sph, n)

            def leaf_hit(lf):
                return ray_box_hit(q_box, lf) if a.leaf_kind == BOX \
                    else ray_sphere_hit(q_sph, lf)
        else:
            q = volume(lanes[k], a.lane_kind)
            own = lane_index[k]

            def node_hit(n):
                return volumes_hit(a.lane_kind, q, a.node_kind, n)

            def leaf_hit(lf):
                return volumes_hit(a.lane_kind, q, a.leaf_kind, lf)
        prune = dedup[k] if dedup is not None else -1
        base = offsets[k] if a.write else 0
        cnt, cur = 0, 1 << (a.start_level - 1)
        while cur > 0:
            level = cur.bit_length()
            first = 1 << (level - 1)
            nreal = first - (a.virtual_leaves >> (a.levels - level))
            skip = cur - first + 1 > nreal or \
                ((cur + 1) << (a.levels - level)) - 1 <= prune
            descend = False
            if not skip and level < a.levels:
                if a.num_nodes > 0:
                    m = min(max(cur - skips[level - 1] - 1, 0),
                            a.num_nodes - 1)
                    descend = bool(node_hit(volume(nodes[m], a.node_kind)))
            elif not skip:
                j = min(max(cur - leaf_base - 1, 0), a.num_leaves - 1)
                if leaf_hit(volume(leaves[j], a.leaf_kind)):
                    if a.write and base + cnt < a.capacity:
                        other = leaf_index[j]
                        out[base + cnt] = {
                            0: (min(own, other), max(own, other)),
                            1: (own, other)}.get(a.emit, (other, own))
                    cnt += 1
            if descend:
                cur *= 2
                continue
            t = ((cur + 1) & -(cur + 1)).bit_length() - 1
            depth = level - a.start_level
            root = cur >> depth
            if t >= depth:
                cur = 0 if root + 1 > a.last_root else root + 1
            else:
                cur = (cur >> t) + 1
        counts[k] = cnt
    return counts, out


def initial_pair(k, n, first):
    """dfs.cu's unranking of lane k's initial pair."""
    pairs = n * (n - 1) // 2
    if k >= pairs:
        return first + k - pairs, first + k - pairs
    lo, hi = 0, max(n - 1, 1) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if mid * (2 * n - mid - 1) // 2 <= k:
            lo = mid
        else:
            hi = mid - 1
    return first + lo, first + lo + 1 + (k - lo * (2 * n - lo - 1) // 2)


def emulate_dfs(a: owalk.DfsArgs):
    """W2 on the packed arguments: returns (counts, out) as int64 arrays."""
    nodes, leaves = rows(a.nodes), rows(a.leaves)
    leaf_index, skips = a.leaf_index.tolist(), a.skips.tolist()
    offsets = None if a.offsets is None else a.offsets.tolist()
    counts = np.zeros(a.K, np.int64)
    out = np.zeros((max(a.capacity, 1), 2), np.int64)
    leaf_base = (1 << (a.levels - 1)) - 1
    top_node = max(a.num_nodes, 1) - 1
    for k in range(a.K):
        st = [None] * (a.depth + 1)
        st[0], sp, cnt = initial_pair(k, a.n, a.first), 1, 0
        base = offsets[k] if a.write else 0
        while sp > 0:
            x, y = st[min(sp - 1, a.depth)]
            sp -= 1
            is_self = x == y
            i1, i2 = max(x, 1), max(y, 1)
            level = i1.bit_length()
            if level == a.levels:
                if not is_self:
                    j1 = min(max(i1 - leaf_base - 1, 0), a.num_leaves - 1)
                    j2 = min(max(i2 - leaf_base - 1, 0), a.num_leaves - 1)
                    if volumes_hit(a.leaf_kind, volume(leaves[j1],
                                                       a.leaf_kind),
                                   a.leaf_kind, volume(leaves[j2],
                                                       a.leaf_kind)):
                        if a.write and base + cnt < a.capacity:
                            u, v = leaf_index[j1], leaf_index[j2]
                            out[base + cnt] = (min(u, v), max(u, v))
                        cnt += 1
                continue
            hit = False
            if not is_self:
                sk = skips[level - 1]
                m1 = min(max(i1 - sk - 1, 0), top_node)
                m2 = min(max(i2 - sk - 1, 0), top_node)
                hit = bool(volumes_hit(
                    a.node_kind, volume(nodes[m1], a.node_kind),
                    a.node_kind, volume(nodes[m2], a.node_kind)))
            first_next = 1 << level
            nreal_next = first_next - (a.virtual_leaves >>
                                       (a.levels - (level + 1)))
            virt2 = (2 * i2 + 1) - first_next + 1 > nreal_next
            self_down = is_self and level < a.levels - 1
            ok = (self_down or hit, (is_self or hit) and not virt2, hit,
                  (self_down or hit) and not virt2)
            for c in range(4):                       # ll, lr, rl, rr
                if ok[c]:
                    st[min(sp, a.depth)] = (2 * i1 + (c >> 1),
                                            2 * i2 + (c & 1))
                    sp += 1
        counts[k] = cnt
    return counts, out


# --------------------------------------------------------------------------
# W1: the records, and the emulation against the JAX package
# --------------------------------------------------------------------------

def fields(vol):
    if isinstance(vol, tb.BSphere):
        return [*vol.xs, vol.r]
    return [*vol.los, *vol.ups]


@pytest.mark.parametrize("box", [False, True])
def test_packed_records_are_the_fields(box):
    """Every record column is its field bit for bit; box records end in two
    zeros; rays are (p, d, 0, 0); indices keep the index dtype."""
    tbvh = to_port(jax_bvh(90, 3, box=box))
    p, d = rays(20, 4)
    tp, td = tray._prep_rays(p, d, torch.float32, "cpu")
    a = owalk.pack_walk(tbvh, 1, tbvh.leaves, dedup_ileaf=dedup_of(tbvh))
    r = owalk.pack_walk(tbvh, 2, (tp, td), ray_offset=7, capacity=16)
    for rec, vol in ((a.nodes, tbvh.nodes), (a.leaves, tbvh.leaves.volume),
                     (a.lanes, tbvh.leaves.volume)):
        cols = fields(vol)
        assert rec.dtype == torch.float32 and rec.is_contiguous()
        assert rec.shape == (cols[0].shape[0], 4 if len(cols) == 4 else 8)
        for c, f in enumerate(cols):
            assert torch.equal(rec[:, c].view(torch.int32),
                               f.contiguous().view(torch.int32))
        assert not rec[:, len(cols):].any()
    for c, f in enumerate([*tp, *td]):
        assert torch.equal(r.lanes[:, c].view(torch.int32),
                           f.contiguous().view(torch.int32))
    assert not r.lanes[:, 6:].any() and r.lane_index is None
    assert torch.equal(a.leaf_index, tbvh.leaves.index)
    assert (a.lane_kind, a.node_kind, a.leaf_kind) == \
        ((BOX, BOX, BOX) if box else (SPHERE, BOX, SPHERE))
    assert (r.lane_kind, r.emit, r.ray_offset, r.write) == (RAY, 3, 7, 1)
    assert r.offsets.dtype == torch.int32 and not r.offsets.any()
    assert a.last_root == 1 and r.last_root == 3 and a.offsets is None


def check_walk(jcount, jwrite, target, start_level, lanes, capacity,
               **spec):
    """The emulation of W1 and the port's routed walk (plain, on the CPU)
    against the JAX package: counts, then the whole buffer written at the
    scanned offsets."""
    jc = np.asarray(jcount())
    a = owalk.pack_walk(target, start_level, lanes, **spec)
    ec, _ = emulate_walk(a)
    ops.reset_launch_counts()
    tc, tout0 = twalk.route_walk(target, start_level, lanes, **spec)
    assert np.array_equal(ec, jc) and np.array_equal(tc.numpy(), jc)
    assert tc.dtype == target.skips.dtype and tout0.shape == (0, 2)
    off = np.cumsum(jc) - jc
    jout = np.asarray(jwrite(off, capacity))
    toff = torch.from_numpy(off).to(target.skips.dtype)
    a = owalk.pack_walk(target, start_level, lanes, capacity=capacity,
                        offsets=toff, **spec)
    ec2, eout = emulate_walk(a)
    tc2, tout = twalk.route_walk(target, start_level, lanes,
                                 capacity=capacity, offsets=toff, **spec)
    assert np.array_equal(ec2, jc) and np.array_equal(tc2.numpy(), jc)
    assert np.array_equal(eout, jout) and np.array_equal(tout.numpy(), jout)
    assert tout.dtype == target.skips.dtype
    assert ops.walk_lanes.launches == 0
    return int(jc.sum())


# (leaves, seed, leaf boxes, node kind, start levels, index bits, capacity)
SELF = {
    "box_nodes": (150, 7, False, "box", (1,), 32, 1024),
    "sphere_nodes": (120, 8, False, "sphere", (1, 3), 32, 1024),
    "box_leaves": (100, 9, True, "box", (2,), 32, 1024),
    "start_level_sweep": (33, 15, False, "box", (1, 2, 3, 4, 5, 6, 7), 32,
                          256),
    "truncated": (150, 7, False, "box", (1,), 32, 40),
    "index64": (90, 10, True, "sphere_leaves_box", (1,), 64, 512),
}


@pytest.mark.parametrize("name", sorted(SELF))
def test_self_walk_emulation_matches_jax(name):
    n, seed, box, kind, levels, bits, cap = SELF[name]
    jbvh = jax_bvh(n, seed, box=box, node_kind=kind, bits=bits)
    tbvh = to_port(jbvh)
    assert tbvh.skips.dtype == (torch.int64 if bits == 64 else torch.int32)
    for sl in levels:
        total = check_walk(
            lambda: jlvt.lvt_count_single(jbvh, sl),
            lambda off, c: jlvt.lvt_write_single(jbvh, jnp.asarray(off), sl,
                                                 c),
            tbvh, sl, tbvh.leaves, cap, dedup_ileaf=dedup_of(tbvh))
        assert total > 0
        if name == "truncated":
            assert total > cap


# (lanes, seed, lanes' leaf boxes, target, seed, target's leaf boxes,
#  node kind, start level, flip)
PAIR = {
    "spheres": (70, 2, False, 50, 3, False, "box", 1, False),
    "spheres_flipped": (70, 2, False, 50, 3, False, "box", 2, True),
    "sphere_nodes": (150, 6, False, 10, 7, False, "sphere", 1, True),
    "mixed_sphere_lanes": (70, 2, False, 50, 4, True, "box", 1, False),
    "mixed_box_lanes": (60, 5, True, 45, 6, False, "box", 1, True),
    "one_leaf_target": (33, 15, False, 1, 16, False, "box", 1, False),
    "one_leaf_lane": (1, 16, False, 33, 15, False, "box", 3, True),
}


@pytest.mark.parametrize("name", sorted(PAIR))
def test_pair_walk_emulation_matches_jax(name):
    """Two trees both ways round (``flip`` says the lanes are bvh2's),
    mixed leaf kinds through the spheres' boxes, and one-leaf trees."""
    nq, sq, bq, nt, st, bt, kind, sl, flip = PAIR[name]
    jq = jax_bvh(nq, sq, box=bq, node_kind=kind, scale=3.0)
    jt = jax_bvh(nt, st, box=bt, node_kind=kind, scale=3.0)
    tq, tt = to_port(jq), to_port(jt)
    total = check_walk(
        lambda: jlvt.lvt_count_pair(jq.leaves, jt, sl, None, flip),
        lambda off, c: jlvt.lvt_write_pair(jq.leaves, jt, jnp.asarray(off),
                                           sl, c, None, flip),
        tt, sl, tq.leaves, 512, flip=flip)
    assert total > 0


# (leaves, seed, leaf boxes, node kind, rays, start level, ray offset)
RAYS = {
    "sphere_leaves": (200, 5, False, "box", 77, 1, 0),
    "box_leaves": (200, 5, True, "box", 77, 2, 0),
    "sphere_nodes": (150, 6, False, "sphere", 60, 1, 0),
}


@pytest.mark.parametrize("name", sorted(RAYS))
def test_ray_walk_emulation_matches_jax(name):
    """Rays with zero direction components (``1 / 0`` and ``0 * inf`` in
    the slab test) and origins in a face plane, on both leaf kinds."""
    n, seed, box, kind, k, sl, _ = RAYS[name]
    jbvh = jax_bvh(n, seed, box=box, node_kind=kind, scale=6.0)
    tbvh = to_port(jbvh)
    p, d = rays(k, 6, 6.0)
    jp, jd = jray._prep_rays(p, d, jnp.float32)
    tp, td = tray._prep_rays(p, d, torch.float32, "cpu")
    with np.errstate(divide="ignore", invalid="ignore"):
        total = check_walk(
            lambda: jray.rays_count(jbvh, jp, jd, sl),
            lambda off, c: jray.rays_write(jbvh, jp, jd, jnp.asarray(off),
                                           sl, c),
            tbvh, sl, (tp, td), 1024)
    assert total > 0


def test_ray_offset_numbers_the_rays_globally():
    """The sharded ray walk's offset moves the ray column and nothing
    else."""
    tbvh = to_port(jax_bvh(200, 5, scale=6.0))
    tp, td = tray._prep_rays(*rays(40, 6, 6.0), torch.float32, "cpu")
    with np.errstate(divide="ignore", invalid="ignore"):
        c, _ = emulate_walk(owalk.pack_walk(tbvh, 1, (tp, td)))
        off = torch.from_numpy(np.cumsum(c) - c).int()
        c0, o0 = emulate_walk(owalk.pack_walk(tbvh, 1, (tp, td), capacity=256,
                                              offsets=off))
        c1, o1 = emulate_walk(owalk.pack_walk(tbvh, 1, (tp, td), capacity=256,
                                              offsets=off, ray_offset=100))
    n = int(c0.sum())
    assert np.array_equal(c0, c1) and n > 0
    assert np.array_equal(o0[:n, 0], o1[:n, 0])
    assert np.array_equal(o0[:n, 1] + 100, o1[:n, 1])


# --------------------------------------------------------------------------
# W2: DFS self-contact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 1000])
def test_dfs_initial_pairs_unrank_as_bfs_lists_them(n):
    """W2 unranks lane k's initial pair from k; the list is
    ``_initial_bvtt_single``'s, self pairs included above the leaves."""
    from implicitbvh_tpu_torch.traverse.bfs import _initial_bvtt_single
    tbvh = port_bvh(n, 3)
    for sl in range(1, tbvh.tree.levels + 1):
        a = owalk.pack_dfs(tbvh, sl)
        i1, i2 = _initial_bvtt_single(tbvh, sl, torch.int32)
        assert a.K == i1.shape[0]
        assert [initial_pair(k, a.n, a.first) for k in range(a.K)] == \
            list(zip(i1.tolist(), i2.tolist()))


# (leaves, seed, leaf boxes, node kind, start levels, index bits, capacity)
DFS = {
    "start_levels": (90, 1, False, "box", (1, 3, 4, 7), 32, 512),
    "sphere_nodes": (60, 3, False, "sphere", (3,), 32, 512),
    "box_leaves": (80, 4, True, "box", (4,), 32, 512),
    "index64_truncated": (70, 5, False, "box", (3,), 64, 12),
}


@pytest.mark.parametrize("name", sorted(DFS))
def test_dfs_emulation_matches_jax(name):
    n, seed, box, kind, levels, bits, cap = DFS[name]
    jbvh = jax_bvh(n, seed, box=box, node_kind=kind, bits=bits, scale=3.5)
    tbvh = to_port(jbvh)
    for sl in levels:
        jc, _ = jdfs.dfs_single_fixed(jbvh, sl)
        jc = np.asarray(jc)
        ec, eout0 = emulate_dfs(owalk.pack_dfs(tbvh, sl))
        ops.reset_launch_counts()
        tc, tout0 = tdfs.dfs_single_fixed(tbvh, sl)
        assert np.array_equal(ec, jc) and np.array_equal(tc.numpy(), jc)
        assert eout0.shape == tout0.shape == (1, 2) and not tout0.any()
        assert jc.sum() > 0
        off = np.cumsum(jc) - jc
        _, jout = jdfs.dfs_single_fixed(jbvh, sl, capacity=cap,
                                        offsets=jnp.asarray(off))
        toff = torch.from_numpy(off).to(tbvh.skips.dtype)
        ec2, eout = emulate_dfs(owalk.pack_dfs(tbvh, sl, cap, toff))
        tc2, tout = tdfs.dfs_single_fixed(tbvh, sl, capacity=cap,
                                          offsets=toff)
        assert np.array_equal(ec2, jc) and np.array_equal(tc2.numpy(), jc)
        assert np.array_equal(eout, np.asarray(jout))
        assert np.array_equal(tout.numpy(), np.asarray(jout))
        assert tout.dtype == tbvh.skips.dtype
        assert ops.dfs_lanes.launches == 0
        if name == "index64_truncated":
            assert jc.sum() > cap


# --------------------------------------------------------------------------
# Routing and host traffic on the CPU
# --------------------------------------------------------------------------

def test_cpu_and_narrow_take_the_plain_loops():
    """CPU tensors take the plain loops, and so does ``narrow`` (a Python
    callback no kernel can call) on every device; no kernel launches, and
    the kernels' wrappers refuse CPU tensors (only the routers choose the
    plain loops)."""
    tbvh = to_port(jax_bvh(80, 11, scale=2.0))
    ops.reset_launch_counts()
    twalk.stackless_walk.steps = 0
    tdfs.dfs_single_fixed.steps = 0
    t1 = tb.traverse_lvt_single_fixed(tbvh, 256)
    t2 = tb.traverse_lvt_single_fixed(tbvh, 256,
                                      narrow=lambda a, b: a.index > 0)
    t3 = tb.traverse(tbvh, tb.DFSTraversal())
    assert twalk.stackless_walk.steps > 0 and tdfs.dfs_single_fixed.steps > 0
    assert int(t1[0]) == int(t2[0]) == t3.num_contacts > 0
    assert torch.equal(t1[1], t2[1])
    assert ops.walk_lanes.launches == ops.dfs_lanes.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.walk_lanes(tbvh, 1, tbvh.leaves)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dfs_lanes(tbvh, 3)
    assert ops.walk_lanes.launches == ops.dfs_lanes.launches == 0
    with pytest.raises(TypeError, match="convert"):
        owalk.pack_walk(to_port(jax_bvh(20, 1, node_kind="sphere")), 1,
                        to_port(jax_bvh(20, 2, box=True)).leaves)


def test_dfs_sprout_and_packing_make_no_host_traffic():
    """DFS's plain loop (its ``sprout`` included) and both packers make no
    tensor from host data and read none back, so on the card they make no
    host-to-device copy and no sync beyond the plain loop's end test."""
    from test_torch_sync_free import no_host_traffic
    tbvh = to_port(jax_bvh(70, 5, scale=3.5))
    p, d = rays(20, 4)
    tp, td = tray._prep_rays(p, d, torch.float32, "cpu")
    off = torch.zeros(tbvh.num_leaves, dtype=torch.int32)
    with no_host_traffic():
        owalk.pack_walk(tbvh, 1, tbvh.leaves, dedup_ileaf=dedup_of(tbvh),
                        capacity=64, offsets=off)
        owalk.pack_walk(tbvh, 2, (tp, td), capacity=64)
        owalk.pack_dfs(tbvh, 3, 64)
        lanes = tbvh.leaves[10:30]          # the sharded walk's lane slice
        owalk.pack_walk(tbvh, 1, lanes, dedup_ileaf=dedup_of(tbvh)[10:30])
    want = tdfs.dfs_single_fixed(tbvh, 3)
    # the plain loop's only host read is its end test: with it allowed,
    # the rest of the loop (the sprout table included) makes no tensor
    # from host data
    calls = []
    real = torch.Tensor.__bool__

    def end_test(self):
        calls.append(1)
        return real(self)

    with no_host_traffic():
        torch.Tensor.__bool__ = end_test
        try:
            got = tdfs.dfs_lanes_plain(tbvh, 3)
        finally:
            torch.Tensor.__bool__ = real
    assert calls and all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_limits_match_the_sources():
    """The wrappers' limits are the kernels' own: ``MAX_LEVELS`` is
    ``walk.cu``'s and ``dfs.cu``'s level check, ``MAX_DFS_DEPTH`` (the
    stack rule at ``MAX_LEVELS`` levels from level 1) is ``dfs.cu``'s
    ``MAX_DEPTH``, and the plain DFS loop sizes its stack by the same rule
    as the packer."""
    import re
    from pathlib import Path
    src = Path(owalk.__file__).resolve().parent.parent / "csrc"
    walk_cu = (src / "walk.cu").read_text()
    dfs_cu = (src / "dfs.cu").read_text()
    assert f"levels > {owalk.MAX_LEVELS}" in walk_cu
    assert f"levels > {owalk.MAX_LEVELS}" in dfs_cu
    depth = re.search(r"constexpr int MAX_DEPTH = (\d+);", dfs_cu)
    assert int(depth.group(1)) == owalk.MAX_DFS_DEPTH == \
        owalk.stack_depth(owalk.MAX_LEVELS, 1) == 91
    tbvh = to_port(jax_bvh(60, 3, scale=3.0))
    for sl in range(1, tbvh.tree.levels + 1):
        assert owalk.pack_dfs(tbvh, sl).depth == \
            owalk.stack_depth(tbvh.tree.levels, sl)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def port_bvh(n, seed, box=False, node_kind=tb.BBox, bits=32, scale=5.0,
             device="cpu"):
    xs, rs = spheres(n, seed, scale)
    if box:
        vol = tb.BBox(torch.from_numpy(xs - rs[:, None]),
                      torch.from_numpy(xs + rs[:, None]), device=device)
    else:
        vol = tb.BSphere(torch.from_numpy(xs), torch.from_numpy(rs),
                         device=device)
    return tb.build(vol, node_kind, options=tb.BVHOptions(index_bits=bits))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_kernels_equal_plain_on_card(bits):
    """W1 (self with dedup on both node kinds, box leaves, two trees both
    ways, mixed kinds, rays on both leaf kinds, one-leaf trees, a
    start-level sweep, a truncating capacity) and W2 (a few start levels)
    against their plain versions on the card: counts and whole buffers."""
    dev = card()
    bv = {k: port_bvh(*a, bits=bits, device=dev) for k, a in {
        "s": (300, 1), "sn": (200, 2, False, tb.BSphere),
        "b": (250, 3, True), "t": (150, 4), "tb": (150, 5, True),
        "one": (1, 6)}.items()}
    p, d = rays(120, 7)
    rp = tuple(torch.from_numpy(p).to(dev))
    rd = tuple(torch.from_numpy(d).to(dev))
    cases = []
    for k in ("s", "sn", "b"):
        for sl in (1, bv[k].tree.levels // 2, bv[k].tree.levels):
            cases.append((bv[k], sl, bv[k].leaves,
                          dict(dedup_ileaf=dedup_of(bv[k]).to(dev))))
    for q, t in (("s", "t"), ("t", "s"), ("s", "tb"), ("b", "t"),
                 ("one", "t"), ("s", "one")):
        for flip in (False, True):
            cases.append((bv[t], 1, bv[q].leaves, dict(flip=flip)))
    for t in ("s", "sn", "b"):
        cases.append((bv[t], 1, (rp, rd), dict(ray_offset=5)))
    for target, sl, lanes, spec in cases:
        c, _ = ops.walk_lanes(target, sl, lanes, **spec)
        pc, _ = twalk.walk_lanes_plain(target, sl, lanes, **spec)
        diag = torch.zeros((c.shape[0], 3), dtype=torch.int32, device=dev)
        dc, _ = ops.walk_lanes(target, sl, lanes, diag=diag, **spec)
        assert torch.equal(c, pc) and torch.equal(dc, c)
        assert bool((diag[:, 0] >= 1).all())
        off = torch.cumsum(c, 0) - c
        cap = max(int(c.sum()) * 3 // 4, 1)
        for capacity in (int(c.sum()) + 5, cap):
            _, out = ops.walk_lanes(target, sl, lanes, capacity=capacity,
                                    offsets=off, **spec)
            _, pout = twalk.walk_lanes_plain(target, sl, lanes,
                                             capacity=capacity, offsets=off,
                                             **spec)
            assert torch.equal(out, pout)
    for k in ("s", "sn", "b"):
        for sl in (2, bv[k].tree.levels // 2, bv[k].tree.levels - 1):
            c, out0 = ops.dfs_lanes(bv[k], sl)
            pc, _ = tdfs.dfs_lanes_plain(bv[k], sl)
            assert torch.equal(c, pc) and not out0.any()
            off = torch.cumsum(c, 0) - c
            n = int(c.sum())
            for capacity in (n + 3, max(n // 2, 1)):
                assert torch.equal(
                    ops.dfs_lanes(bv[k], sl, capacity, off)[1],
                    tdfs.dfs_lanes_plain(bv[k], sl, capacity, off)[1])


@pytest.mark.gpu
def test_captured_pair_walk_replays_on_new_inputs():
    """``traverse_lvt_pair_fixed`` makes no host sync on the card, is
    captured in a CUDA graph and replays on new lanes equal to the eager
    call."""
    dev = card()
    b1 = port_bvh(900, 11, device=dev)
    b2 = port_bvh(400, 12, device=dev)
    moved = port_bvh(900, 13, device=dev)

    def run():
        return tb.traverse_lvt_pair_fixed(b1, b2, 4096)

    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ops.reset_launch_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    assert ops.walk_lanes.launches == 2
    g.replay()
    torch.cuda.synchronize()
    assert int(out[0]) == int(want[0]) > 0 and torch.equal(out[1], want[1])
    statics = [*b1.leaves.volume.xs, b1.leaves.volume.r, b1.leaves.index]
    for s, f in zip(statics, [*moved.leaves.volume.xs, moved.leaves.volume.r,
                              moved.leaves.index]):
        s.copy_(f)
    g.replay()
    torch.cuda.synchronize()
    eager = run()
    assert int(out[0]) == int(eager[0]) and torch.equal(out[1], eager[1])
    g.reset()
