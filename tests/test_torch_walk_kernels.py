"""The walk kernels W1 (``csrc/walk.cu``) and W2 (``csrc/dfs.cu``) against
the JAX package's device loops, on the CPU.

The CPU has no nvcc and no card, so the kernels' algorithm is held here
through an emulation in numpy of their designs: W1's two stages split by
subtree (the roots each lane reaches at the split level, their subtrees
walked in a shuffled order, the scan of each lane's slots in root order),
or its one thread a lane; W2's rounds of work items (B steps an item, an
unfinished item's stack listed as its children top first, the in-place
rule and the holes at the work list's capacity, the sums of each item's
subtree, the places, a second run of every item writing).  Every step is
the kernels' (the same level, virtual, dedup, climb and push rules, the
same float32 or float64 operations rounded one at a time, a sphere's box
in its own type in mixed precisions, the NaN rule ``(x < y) ? x : y``),
over the records the wrappers pack (``ops.walk.pack_walk`` and
``pack_dfs``, themselves held bit for bit against the volumes' fields).
Its per-lane counts, the offsets and the whole written buffer in order
must equal the JAX package's ``stackless_walk`` (through ``lvt_*`` and
``rays_*``) and ``dfs_single_fixed`` exactly, in float32 and (x64 is on in
this process) float64, as must the port's routed walk on CPU tensors (the
plain loops); so must the emulation under other splits and schedules,
and a lane's items' rows concatenated in order must be its rows.
Tolerance: exact.  The ``gpu`` cases hold the kernels against their plain
versions on the card (float32, float64, mixed precisions, both W1 routes,
W2's in-place rule) and replay a captured ``traverse_lvt_pair_fixed`` and
DFS count -> scan -> write on new inputs.
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
from implicitbvh_tpu_torch import tracing
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

def spheres(n, seed, scale=5.0, dtype=F):
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 3), dtype=dtype) * dtype(scale)
    rs = (rng.random(n, dtype=dtype) * dtype(0.4) +
          dtype(0.05)).astype(dtype)
    return xs, rs


def to_port(jbvh):
    from test_torch_pair import to_port as carry
    return carry(jbvh)


def jax_bvh(n, seed, box=False, node_kind="box", bits=32, scale=5.0,
            dtype=F):
    xs, rs = spheres(n, seed, scale, dtype)
    if box:
        vol = jb.BBox(jnp.asarray(xs - rs[:, None]),
                      jnp.asarray(xs + rs[:, None]))
    else:
        vol = jb.BSphere(jnp.asarray(xs), jnp.asarray(rs))
    kind = jb.BSphere if node_kind == "sphere" else jb.BBox
    return jb.build(vol, kind, options=jb.BVHOptions(index_bits=bits))


def rays(k, seed, scale=5.0, dtype=F):
    """(3, k) rays; some direction components are zero, and some rays
    start in a coordinate plane of the scene."""
    rng = np.random.default_rng(seed)
    p = (rng.random((3, k)) * scale).astype(dtype)
    d = (rng.random((3, k)) - 0.5).astype(dtype)
    d[0, :k // 4] = 0.0
    d[1, k // 8:k // 3] = 0.0
    p[2, :k // 6] = 0.0
    return p, d


def dedup_of(tbvh):
    n, levels = tbvh.num_leaves, tbvh.tree.levels
    return torch.arange(1, n + 1, dtype=tbvh.skips.dtype) + \
        (1 << (levels - 1)) - 1


# --------------------------------------------------------------------------
# The emulation: walk.cu's stages and dfs.cu's rounds, in numpy
# --------------------------------------------------------------------------

def rows(t):
    return [list(r) for r in t.numpy()]


def narrowed(single, f, *xs):
    """``f`` of ``xs`` rounded in float32 when ``single`` (a float32 side of
    a float64 walk), widened back."""
    if single:
        return np.float64(f(*(np.float32(x) for x in xs)))
    return f(*xs)


def box_of_sphere(s, single=False):
    return [narrowed(single, lambda c, r: c - r, s[k], s[3])
            for k in range(3)] + \
        [narrowed(single, lambda c, r: c + r, s[k], s[3]) for k in range(3)]


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


class Walk:
    """W1 (``csrc/walk.cu``) on the packed arguments: a lane's tests as
    ``prepare``, ``node_hit`` and ``leaf_hit`` make them, and the walk of
    one lane from a node, its climb capped at a level and a root."""

    def __init__(self, a: owalk.WalkArgs):
        self.a = a
        self.nodes, self.leaves = rows(a.nodes), rows(a.leaves)
        self.lanes = rows(a.lanes)
        self.leaf_index, self.skips = a.leaf_index.tolist(), a.skips.tolist()
        self.lane_index = None if a.lane_index is None else \
            a.lane_index.tolist()
        self.dedup = None if a.dedup is None else a.dedup.tolist()
        self.offsets = None if a.offsets is None else a.offsets.tolist()
        self.steps = 0

    def tests(self, k):
        """(node_hit, leaf_hit, own index, prune) of lane k."""
        a = self.a
        if a.lane_kind == RAY:
            r = self.lanes[k]
            p, d = r[:3], r[3:6]
            q_box = p + [F(1) / c for c in d]
            q_sph = p + d + [(d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]]

            def node_hit(n):
                return ray_box_hit(q_box, n) if a.node_kind == BOX \
                    else ray_sphere_hit(q_sph, n)

            def leaf_hit(lf):
                return ray_box_hit(q_box, lf) if a.leaf_kind == BOX \
                    else ray_sphere_hit(q_sph, lf)
            own = a.ray_offset + k + 1
        else:
            q = volume(self.lanes[k], a.lane_kind)
            q_box = box_of_sphere(q, a.lane_single) \
                if a.lane_kind == SPHERE else q

            def node_hit(n):
                return sphere_hit(q, n) if a.node_kind == SPHERE \
                    else box_hit(q_box, n)

            def leaf_hit(lf):
                if a.lane_kind == SPHERE and a.leaf_kind == SPHERE:
                    return sphere_hit(q, lf)
                if a.leaf_kind == SPHERE:
                    return box_hit(q, box_of_sphere(lf, a.tree_single))
                return box_hit(q_box, lf)
            own = self.lane_index[k]
        prune = self.dedup[k] if self.dedup is not None else -1
        return node_hit, leaf_hit, own, prune

    def walk(self, k, cur, top, last, base=None, out=None, stop=0,
             marks=None):
        """Lane k from ``cur``; rows at ``base`` + the running count when
        ``out`` is given; at level ``stop`` (stage 1) the roots reached go
        to ``marks`` instead of being walked.  Returns the rows found."""
        a = self.a
        node_hit, leaf_hit, own, prune = self.tests(k)
        leaf_base = (1 << (a.levels - 1)) - 1
        cnt = 0
        while cur > 0:
            self.steps += 1
            level = cur.bit_length()
            first = 1 << (level - 1)
            nreal = first - (a.virtual_leaves >> (a.levels - level))
            skip = cur - first + 1 > nreal or \
                ((cur + 1) << (a.levels - level)) - 1 <= prune
            descend = False
            if skip:
                pass
            elif level == stop:
                marks.append(cur)
            elif level < a.levels:
                if a.num_nodes > 0:
                    m = min(max(cur - self.skips[level - 1] - 1, 0),
                            a.num_nodes - 1)
                    descend = bool(node_hit(volume(self.nodes[m],
                                                   a.node_kind)))
            else:
                j = min(max(cur - leaf_base - 1, 0), a.num_leaves - 1)
                if leaf_hit(volume(self.leaves[j], a.leaf_kind)):
                    if out is not None and base + cnt < a.capacity:
                        other = self.leaf_index[j]
                        out[base + cnt] = {
                            0: (min(own, other), max(own, other)),
                            1: (own, other)}.get(a.emit, (other, own))
                    cnt += 1
            if descend:
                cur *= 2
                continue
            t = ((cur + 1) & -(cur + 1)).bit_length() - 1
            depth = level - top
            root = cur >> depth
            if t >= depth:
                cur = 0 if root + 1 > last else root + 1
            else:
                cur = (cur >> t) + 1
        return cnt

    def slots(self):
        """Stage 1: {(lane, slot): None} of the level-``split`` roots each
        lane reaches, slot j the root ``first_slot + j``."""
        a = self.a
        first_root = 1 << (a.start_level - 1)
        root0 = first_root << (a.split - a.start_level)
        reached = {}
        for k in range(a.K):
            marks = []
            self.walk(k, first_root, a.start_level, a.last_root,
                      stop=a.split, marks=marks)
            for c in marks:
                reached[(k, c - root0)] = c
        return reached


def emulate_walk(a: owalk.WalkArgs, seed=0, items=None):
    """W1 on the packed arguments, as walk.cu runs it: one thread a lane
    (``a.M == 0``), or stage 1, stage 2's slots in an order drawn from
    ``seed`` (the grid takes them in any order), the scan of each lane's
    slots in root order and, in the write pass, stage 2 again writing at
    the scanned rows.  Returns (counts, out) as int64 arrays; ``items``, a
    dict, gets each slot's root and rows."""
    w = Walk(a)
    counts = np.zeros(a.K, np.int64)
    out = np.zeros((a.capacity, 2), np.int64)
    write = bool(a.write)
    first_root = 1 << (a.start_level - 1)
    if a.M == 0:
        for k in range(a.K):
            counts[k] = w.walk(k, first_root, a.start_level, a.last_root,
                               w.offsets[k] if write else 0,
                               out if write else None)
        return counts, out
    roots = w.slots()
    keys = list(roots)
    order = np.random.default_rng(seed).permutation(len(keys))
    own = {}
    for i in order:
        k, j = keys[i]
        own[(k, j)] = w.walk(k, roots[(k, j)], a.split, roots[(k, j)])
    pos = {}
    for k in range(a.K):
        run = w.offsets[k] if write else 0
        start = run
        for j in range(a.M):
            if (k, j) in own:
                pos[(k, j)] = run
                run += own[(k, j)]
        counts[k] = run - start
    if write:
        for i in order[::-1]:
            k, j = keys[i]
            w.walk(k, roots[(k, j)], a.split, roots[(k, j)], pos[(k, j)],
                   out)
    if items is not None:
        items.update({key: (roots[key], own[key]) for key in keys})
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


class Dfs:
    """W2 (``csrc/dfs.cu``) on the packed arguments: ``run`` pops and
    pushes a stack as a thread of the kernel does."""

    def __init__(self, a: owalk.DfsArgs):
        self.a = a
        self.nodes, self.leaves = rows(a.nodes), rows(a.leaves)
        self.leaf_index, self.skips = a.leaf_index.tolist(), a.skips.tolist()

    def run(self, st, budget, base=None, out=None):
        """At most ``budget`` steps on the stack ``st`` (a list, top last);
        returns (steps, rows found), rows at ``base`` + the running count
        when ``out`` is given."""
        a = self.a
        leaf_base = (1 << (a.levels - 1)) - 1
        top_node = max(a.num_nodes, 1) - 1
        steps = cnt = 0
        while st and steps < budget:
            steps += 1
            x, y = st.pop()
            is_self = x == y
            i1, i2 = max(x, 1), max(y, 1)
            level = i1.bit_length()
            if level == a.levels:
                if not is_self:
                    j1 = min(max(i1 - leaf_base - 1, 0), a.num_leaves - 1)
                    j2 = min(max(i2 - leaf_base - 1, 0), a.num_leaves - 1)
                    if volumes_hit(a.leaf_kind, volume(self.leaves[j1],
                                                       a.leaf_kind),
                                   a.leaf_kind, volume(self.leaves[j2],
                                                       a.leaf_kind)):
                        if out is not None and base + cnt < a.capacity:
                            u, v = self.leaf_index[j1], self.leaf_index[j2]
                            out[base + cnt] = (min(u, v), max(u, v))
                        cnt += 1
                continue
            hit = False
            if not is_self:
                sk = self.skips[level - 1]
                m1 = min(max(i1 - sk - 1, 0), top_node)
                m2 = min(max(i2 - sk - 1, 0), top_node)
                hit = bool(volumes_hit(
                    a.node_kind, volume(self.nodes[m1], a.node_kind),
                    a.node_kind, volume(self.nodes[m2], a.node_kind)))
            first_next = 1 << level
            nreal_next = first_next - (a.virtual_leaves >>
                                       (a.levels - (level + 1)))
            virt2 = (2 * i2 + 1) - first_next + 1 > nreal_next
            self_down = is_self and level < a.levels - 1
            ok = (self_down or hit, (is_self or hit) and not virt2, hit,
                  (self_down or hit) and not virt2)
            for c in range(4):                       # ll, lr, rl, rr
                if ok[c]:
                    assert len(st) < a.depth + 1
                    st.append((2 * i1 + (c >> 1), 2 * i2 + (c & 1)))
        return steps, cnt


def emulate_dfs(a: owalk.DfsArgs, seed=0, stats=None):
    """W2 on the packed arguments, as dfs.cu runs it: rounds of work items
    (each round's items in an order drawn from ``seed``: the grid takes
    them, and appends children, in any order), B steps an item but in the
    last round, children listed top of the stack first, the in-place rule
    at the list's capacity (the reservation that crosses it leaves holes,
    which every later step skips); the count pass sums each lane's items, the
    write pass sums each item's subtree (last round first), places round
    0's items at the offsets and each child after its parent's own rows
    and its earlier siblings, and runs every item again writing.  Returns
    (counts, out) as int64 arrays; ``stats``, a dict, gets the rounds'
    bounds, the items that ran on in place, each item's (lane, pair, own
    rows, children) and its first child."""
    d = Dfs(a)
    rng = np.random.default_rng(seed)
    K, cap = a.K, a.cap
    pair = [initial_pair(k, a.n, a.first) for k in range(K)]
    lane = list(range(K))
    own, first, nchild = [0] * K, [0] * K, [0] * K
    bounds, in_place = [0, K], 0
    for r in range(a.rounds):
        last = r == a.rounds - 1
        lo, hi = bounds[r], bounds[r + 1]
        for i in lo + rng.permutation(hi - lo):
            if lane[i] < 0:                          # a hole
                continue
            st = [pair[i]]
            _, cnt = d.run(st, 1 << 62 if last else a.budget)
            room = len(pair) + len(st) <= cap
            # the children, top of the stack first; a reservation that
            # crosses the capacity leaves holes below it
            new = list(reversed(st)) if room else \
                [(0, 0)] * max(cap - len(pair), 0) if st else []
            if st and room:
                first[i], nchild[i] = len(pair), len(st)
            elif st:                                 # no room: in place
                in_place += 1
                cnt += d.run(st, 1 << 62)[1]
            for p in new:
                pair.append(p)
                lane.append(lane[i] if room else -1)
                own.append(0)
                first.append(0)
                nchild.append(0)
            own[i] = cnt
        if not last:
            bounds.append(len(pair))
    counts = np.zeros(K, np.int64)
    out = np.zeros((max(a.capacity, 1), 2), np.int64)
    if stats is not None:
        stats.update(bounds=bounds, in_place=in_place, first=first,
                     items=list(zip(lane, pair, own, nchild)))
    if not a.write:
        for i, k in enumerate(lane):
            if k >= 0:
                counts[k] += own[i]
        return counts, out
    total = list(own)
    for r in range(a.rounds - 2, -1, -1):
        for i in range(bounds[r], bounds[r + 1]):
            total[i] = own[i] + sum(total[first[i]:first[i] + nchild[i]])
    offsets = a.offsets.tolist()
    pos = [0] * len(pair)
    for r in range(max(a.rounds - 1, 1)):
        for i in range(bounds[r], bounds[r + 1]):
            if r == 0:
                pos[i] = offsets[i]
                counts[i] = total[i]
            at = pos[i] + own[i]
            for c in range(first[i], first[i] + nchild[i]):
                pos[c] = at
                at += total[c]
    for i in rng.permutation(len(pair)):
        if lane[i] >= 0:
            d.run([pair[i]], a.budget if nchild[i] else 1 << 62, pos[i], out)
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


def walk_splits(a: owalk.WalkArgs):
    """W1's packed arguments, then the same walk in one stage and split at
    the leaf level: each gives the same counts and rows."""
    roots = a.last_root - (1 << (a.start_level - 1)) + 1
    return [a] + [a._replace(split=s, M=roots << (s - a.start_level)
                             if s > a.start_level else 0)
                  for s in sorted({a.start_level, a.levels} - {a.split})]


def check_walk(jcount, jwrite, target, start_level, lanes, capacity,
               **spec):
    """The emulation of W1 (as packed, in one stage and split at the leaf
    level) and the port's routed walk (plain, on the CPU) against the JAX
    package: counts, then the whole buffer written at the scanned
    offsets."""
    jc = np.asarray(jcount())
    a = owalk.pack_walk(target, start_level, lanes, **spec)
    assert (a.M > 0) == (a.split > a.start_level)
    for v in walk_splits(a):
        assert np.array_equal(emulate_walk(v)[0], jc)
    ops.reset_launch_counts()
    tc, tout0 = twalk.route_walk(target, start_level, lanes, **spec)
    assert np.array_equal(tc.numpy(), jc)
    assert tc.dtype == target.skips.dtype and tout0.shape == (0, 2)
    off = np.cumsum(jc) - jc
    jout = np.asarray(jwrite(off, capacity))
    toff = torch.from_numpy(off).to(target.skips.dtype)
    a = owalk.pack_walk(target, start_level, lanes, capacity=capacity,
                        offsets=toff, **spec)
    for v in walk_splits(a):
        ec2, eout = emulate_walk(v, seed=1)
        assert np.array_equal(ec2, jc) and np.array_equal(eout, jout)
    tc2, tout = twalk.route_walk(target, start_level, lanes,
                                 capacity=capacity, offsets=toff, **spec)
    assert np.array_equal(tc2.numpy(), jc)
    assert np.array_equal(tout.numpy(), jout)
    assert tout.dtype == target.skips.dtype
    assert ops.launch_count(ops.walk_lanes) == 0
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


def dfs_schedules(a: owalk.DfsArgs):
    """W2's packed arguments, then the same pass in rounds of 3 steps (more
    rounds, more spills, room for every item) and in rounds of 2 steps with
    a work list that fills (the in-place rule): each gives the same counts
    and rows."""
    return [a, a._replace(budget=3, rounds=6, cap=1 << 24),
            a._replace(budget=2, rounds=4, cap=a.K + 7)]


def check_dfs(jbvh, tbvh, sl, cap):
    """The emulation of W2 (each of :func:`dfs_schedules`) and the port's
    routed pass (plain, on the CPU) against the JAX package's
    ``dfs_single_fixed``: counts, then the whole buffer written at the
    scanned offsets.  Returns the total."""
    jc, _ = jdfs.dfs_single_fixed(jbvh, sl)
    jc = np.asarray(jc)
    for v in dfs_schedules(owalk.pack_dfs(tbvh, sl)):
        ec, eout0 = emulate_dfs(v)
        assert np.array_equal(ec, jc) and eout0.shape == (1, 2)
    ops.reset_launch_counts()
    tc, tout0 = tdfs.dfs_single_fixed(tbvh, sl)
    assert np.array_equal(tc.numpy(), jc)
    assert tout0.shape == (1, 2) and not tout0.any()
    assert jc.sum() > 0
    off = np.cumsum(jc) - jc
    _, jout = jdfs.dfs_single_fixed(jbvh, sl, capacity=cap,
                                    offsets=jnp.asarray(off))
    jout = np.asarray(jout)
    toff = torch.from_numpy(off).to(tbvh.skips.dtype)
    for v in dfs_schedules(owalk.pack_dfs(tbvh, sl, cap, toff)):
        ec2, eout = emulate_dfs(v, seed=1)
        assert np.array_equal(ec2, jc) and np.array_equal(eout, jout)
    tc2, tout = tdfs.dfs_single_fixed(tbvh, sl, capacity=cap, offsets=toff)
    assert np.array_equal(tc2.numpy(), jc)
    assert np.array_equal(tout.numpy(), jout)
    assert tout.dtype == tbvh.skips.dtype
    assert ops.launch_count(ops.dfs_lanes) == 0
    return int(jc.sum())


@pytest.mark.parametrize("name", sorted(DFS))
def test_dfs_emulation_matches_jax(name):
    n, seed, box, kind, levels, bits, cap = DFS[name]
    jbvh = jax_bvh(n, seed, box=box, node_kind=kind, bits=bits, scale=3.5)
    tbvh = to_port(jbvh)
    for sl in levels:
        total = check_dfs(jbvh, tbvh, sl, cap)
        if name == "index64_truncated":
            assert total > cap


# --------------------------------------------------------------------------
# float64 walks, and the splits of a lane's work
# --------------------------------------------------------------------------

F64_SELF = {"box_nodes": ("box", False), "sphere_nodes": ("sphere", False),
            "box_leaves": ("box", True)}


@pytest.mark.parametrize("name", sorted(F64_SELF))
def test_float64_self_walk_and_dfs_match_jax(name):
    """float64 volumes (x64 is on in this process): the JAX package's LVT
    self walk and DFS against the port's plain loops and the emulation of
    W1 and W2 over float64 records, counts and buffers in order."""
    kind, box = F64_SELF[name]
    jbvh = jax_bvh(110, 21, box=box, node_kind=kind, scale=3.5,
                   dtype=np.float64)
    tbvh = to_port(jbvh)
    assert tbvh.leaves.volume.dtype == tbvh.nodes.dtype == torch.float64
    a = owalk.pack_walk(tbvh, 1, tbvh.leaves, dedup_ileaf=dedup_of(tbvh))
    assert a.nodes.dtype == a.leaves.dtype == torch.float64
    assert (a.value_bits, a.lane_single, a.tree_single) == (64, 0, 0)
    assert check_walk(
        lambda: jlvt.lvt_count_single(jbvh, 1),
        lambda off, c: jlvt.lvt_write_single(jbvh, jnp.asarray(off), 1, c),
        tbvh, 1, tbvh.leaves, 1024, dedup_ileaf=dedup_of(tbvh)) > 0
    sl = tbvh.tree.levels // 2
    assert owalk.pack_dfs(tbvh, sl).value_bits == 64
    check_dfs(jbvh, tbvh, sl, 512)


# (lanes' dtype, target's dtype, lanes' leaf boxes, flip)
F64_PAIR = {"float64": (np.float64, np.float64, False, False),
            "float64_lanes_float32_tree": (np.float64, F, False, True),
            "float32_lanes_float64_tree": (F, np.float64, False, False),
            "mixed_box_lanes": (F, np.float64, True, True)}


@pytest.mark.parametrize("name", sorted(F64_PAIR))
def test_float64_pair_walk_matches_jax(name):
    """Two trees in float64, and in mixed precisions, which JAX and torch
    promote to float64 (a sphere's box rounded in the sphere's own type):
    the JAX package's LVT pair walk against the plain loop and W1's
    emulation."""
    dq, dt, bq, flip = F64_PAIR[name]
    jq = jax_bvh(70, 22, box=bq, scale=3.0, dtype=dq)
    jt = jax_bvh(50, 23, scale=3.0, dtype=dt)
    tq, tt = to_port(jq), to_port(jt)
    a = owalk.pack_walk(tt, 1, tq.leaves, flip=flip)
    assert a.value_bits == 64 and a.lanes.dtype == torch.float64
    assert (a.lane_single, a.tree_single) == (int(dq == F), int(dt == F))
    assert check_walk(
        lambda: jlvt.lvt_count_pair(jq.leaves, jt, 1, None, flip),
        lambda off, c: jlvt.lvt_write_pair(jq.leaves, jt, jnp.asarray(off),
                                           1, c, None, flip),
        tt, 1, tq.leaves, 512, flip=flip) > 0


@pytest.mark.parametrize("box", [False, True])
def test_float64_ray_walk_matches_jax(box):
    """float64 rays on both leaf kinds, zero direction components
    included; rays of another type than the BVH's are refused (the ray
    entry points give them the BVH's)."""
    jbvh = jax_bvh(150, 24, box=box, scale=6.0, dtype=np.float64)
    tbvh = to_port(jbvh)
    p, d = rays(60, 25, 6.0, np.float64)
    jp, jd = jray._prep_rays(p, d, jnp.float64)
    tp, td = tray._prep_rays(p, d, torch.float64, "cpu")
    with np.errstate(divide="ignore", invalid="ignore"):
        assert check_walk(
            lambda: jray.rays_count(jbvh, jp, jd, 1),
            lambda off, c: jray.rays_write(jbvh, jp, jd, jnp.asarray(off), 1,
                                           c),
            tbvh, 1, (tp, td), 1024) > 0
    with pytest.raises(TypeError, match="rays of"):
        owalk.pack_walk(tbvh, 1, tuple(tuple(c.float() for c in x)
                                       for x in (tp, td)))


def test_walk_splits_few_lanes_below_the_start_level():
    """Few lanes split: 12 rays and a dense scene of coincident spheres give
    a split level below the start level (the rays' at the first level, the
    dense scene's at its built level); many lanes walk in one stage.  Both
    against the JAX package."""
    jbvh = jax_bvh(300, 26, scale=6.0)
    tbvh = to_port(jbvh)
    p, d = rays(12, 27, 6.0)
    jp, jd = jray._prep_rays(p, d, jnp.float32)
    tp, td = tray._prep_rays(p, d, torch.float32, "cpu")
    a = owalk.pack_walk(tbvh, 1, (tp, td))
    assert a.split > a.start_level and a.M == 1 << (a.split - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        assert check_walk(
            lambda: jray.rays_count(jbvh, jp, jd, 1),
            lambda off, c: jray.rays_write(jbvh, jp, jd, jnp.asarray(off), 1,
                                           c),
            tbvh, 1, (tp, td), 256) > 0
    n = 40
    xs, rs = np.zeros((n, 3), F), np.full(n, F(0.5))
    jd_bvh = jb.build(jb.BSphere(jnp.asarray(xs), jnp.asarray(rs)), jb.BBox)
    td_bvh = to_port(jd_bvh)
    sl = 2
    a = owalk.pack_walk(td_bvh, sl, td_bvh.leaves,
                        dedup_ileaf=dedup_of(td_bvh))
    assert a.split > sl and a.M == 2 << (a.split - sl)
    assert check_walk(
        lambda: jlvt.lvt_count_single(jd_bvh, sl),
        lambda off, c: jlvt.lvt_write_single(jd_bvh, jnp.asarray(off), sl,
                                             c),
        td_bvh, sl, td_bvh.leaves, 1024,
        dedup_ileaf=dedup_of(td_bvh)) == n * (n - 1) // 2
    assert owalk.split_level(owalk.SPLIT_LANES, 20, 1, 1) == 1
    assert owalk.split_level(1, 20, 1, 1) == 11
    assert owalk.split_level(1000, 19, 1, 1) == 10


class Rows(dict):
    """An output buffer that keeps the rows written, by row."""

    def __init__(self, base=0):
        super().__init__()
        self.base = base

    def list(self):
        return [self[i] for i in sorted(self)]


def test_split_identity_a_lanes_items_concatenate_to_its_rows():
    """The concatenation of a lane's items' rows, in order, is the lane's
    rows: W1's level-s subtrees in root order, W2's items in the order of
    their tree (an item's own rows, then each child's in turn)."""
    tbvh = port_bvh(160, 28, scale=3.0)
    big = 1 << 40
    a = owalk.pack_walk(tbvh, 1, tbvh.leaves, dedup_ileaf=dedup_of(tbvh))
    a = a._replace(capacity=big)
    w = Walk(a)
    items = {}
    emulate_walk(a._replace(capacity=0), items=items)
    multi = 0
    for k in range(a.K):
        whole = Rows()
        w.walk(k, 1, 1, 1, 0, whole)
        mine = sorted((j, root) for (kk, j), (root, _) in items.items()
                      if kk == k)
        multi += len(mine) > 1
        got = []
        for _, root in mine:
            part = Rows()
            w.walk(k, root, a.split, root, 0, part)
            got += part.list()
        assert got == whole.list()
    assert multi > 10
    sl = tbvh.tree.levels // 2
    b = owalk.pack_dfs(tbvh, sl)._replace(budget=3, rounds=5,
                                          capacity=big)
    d = Dfs(b)
    stats = {}
    emulate_dfs(b._replace(capacity=0), stats=stats)
    items, first = stats["items"], stats["first"]

    def item_rows(i):
        part = Rows()
        d.run([items[i][1]], b.budget if items[i][3] else 1 << 62, 0, part)
        rows_ = part.list()
        for c in range(first[i], first[i] + items[i][3]):
            rows_ += item_rows(c)
        return rows_

    deep = 0
    for k in range(b.K):
        whole = Rows()
        d.run([initial_pair(k, b.n, b.first)], 1 << 62, 0, whole)
        assert item_rows(k) == whole.list()
        deep += any(items[c][3] for c in range(first[k],
                                                first[k] + items[k][3]))
    assert deep > 0   # some lane's children listed children of their own


def test_dfs_lanes_spill_over_rounds_and_fill_the_list():
    """Rounds of a few steps: some lane's items spill in more than one
    round; a work list with room for 7 items beyond the lanes fills (the
    reservation that crosses its end leaves holes) and its items run on in
    place.  Both give JAX's counts and rows (checked in
    :func:`check_dfs`); here the schedule's shape."""
    tbvh = port_bvh(120, 29, scale=3.0)
    a = owalk.pack_dfs(tbvh, tbvh.tree.levels // 2)
    spill, full = dfs_schedules(a)[1:]
    stats = {}
    emulate_dfs(spill, stats=stats)
    b = stats["bounds"]
    assert len(b) == spill.rounds + 1 and b[3] > b[2] > b[1] == a.K
    lanes_by_round = [{stats["items"][i][0] for i in range(b[r], b[r + 1])}
                      for r in range(1, 3)]
    assert lanes_by_round[0] & lanes_by_round[1]
    assert stats["in_place"] == 0
    stats = {}
    emulate_dfs(full, stats=stats)
    assert stats["in_place"] > 0 and len(stats["items"]) == full.cap
    assert any(k < 0 for k, *_ in stats["items"])     # a hole below it
    budget, rounds, cap = owalk.dfs_schedule(131328, 21, 10)
    assert (budget, rounds, cap) == (32, 9, 131328 * 32)
    assert owalk.dfs_schedule(10, 5, 4) == (32, 1, 320)


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
    tracing.reset("walk.steps")
    tracing.reset("dfs.steps")
    t1 = tb.traverse_lvt_single_fixed(tbvh, 256)
    t2 = tb.traverse_lvt_single_fixed(tbvh, 256,
                                      narrow=lambda a, b: a.index > 0)
    t3 = tb.traverse(tbvh, tb.DFSTraversal())
    assert tracing.counter("walk.steps") > 0 and \
        tracing.counter("dfs.steps") > 0
    assert int(t1[0]) == int(t2[0]) == t3.num_contacts > 0
    assert torch.equal(t1[1], t2[1])
    assert ops.launch_count(ops.walk_lanes) == \
        ops.launch_count(ops.dfs_lanes) == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.walk_lanes(tbvh, 1, tbvh.leaves)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dfs_lanes(tbvh, 3)
    assert ops.launch_count(ops.walk_lanes) == \
        ops.launch_count(ops.dfs_lanes) == 0
    with pytest.raises(TypeError, match="convert"):
        owalk.pack_walk(to_port(jax_bvh(20, 1, node_kind="sphere")), 1,
                        to_port(jax_bvh(20, 2, box=True)).leaves)


def test_dfs_sprout_and_packing_make_no_host_traffic():
    """DFS's plain loop (its ``sprout`` included) and both packers (split
    walks, float64 and mixed records, the DFS schedule) make no tensor from
    host data and read none back, so on the card they make no
    host-to-device copy and no sync beyond the plain loop's end test."""
    from test_torch_sync_free import no_host_traffic
    tbvh = to_port(jax_bvh(70, 5, scale=3.5))
    t64 = to_port(jax_bvh(70, 5, scale=3.5, dtype=np.float64))
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
        # float64 records, and a float32 tree under float64 lanes
        owalk.pack_walk(t64, 1, t64.leaves, dedup_ileaf=dedup_of(t64),
                        capacity=64, offsets=off)
        owalk.pack_walk(tbvh, 1, t64.leaves, capacity=64)
        owalk.pack_dfs(t64, 3, 64)
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
    rounds = re.search(r"constexpr int MAX_ROUNDS = (\d+);", dfs_cu)
    assert int(rounds.group(1)) == owalk.DFS_MAX_ROUNDS
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
             device="cpu", dtype=F):
    xs, rs = spheres(n, seed, scale, dtype)
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
        diag = torch.empty((c.shape[0] + 2, 4), dtype=torch.int32,
                           device=dev)
        dc, _ = ops.walk_lanes(target, sl, lanes, diag=diag, **spec)
        assert torch.equal(c, pc) and torch.equal(dc, c)
        assert bool((diag[:-2, 0] >= 1).all())
        assert bool((diag[:-2, 3] <= diag[:-2, 0]).all())
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
    assert ops.launch_count(ops.walk_lanes) == 2
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


@pytest.mark.gpu
def test_float64_and_split_kernels_equal_plain_on_card(monkeypatch):
    """W1 and W2 in float64 and in mixed precisions (self with dedup, two
    trees both ways, float64 rays on both leaf kinds, DFS), each lane count
    walked split by subtree and in one stage (``SPLIT_LANES``), and W2 in
    rounds of 2 steps with a work list that fills (the in-place rule),
    against the plain loops on the card: counts and whole buffers."""
    dev = card()
    d64 = np.float64
    s64 = port_bvh(300, 31, dtype=d64, device=dev)
    b64 = port_bvh(250, 32, box=True, dtype=d64, device=dev)
    t32 = port_bvh(150, 33, device=dev)
    p, d = rays(120, 34, dtype=d64)
    rp = tuple(torch.from_numpy(p).to(dev))
    rd = tuple(torch.from_numpy(d).to(dev))
    cases = [(s64, 1, s64.leaves, dict(dedup_ileaf=dedup_of(s64).to(dev))),
             (b64, 2, b64.leaves, dict(dedup_ileaf=dedup_of(b64).to(dev))),
             (t32, 1, s64.leaves, dict(flip=True)),
             (s64, 1, t32.leaves, {}), (t32, 1, b64.leaves, {}),
             (s64, 1, (rp, rd), {}), (b64, 1, (rp, rd), dict(ray_offset=3))]
    for split_lanes in (owalk.SPLIT_LANES, 1):
        monkeypatch.setattr(owalk, "SPLIT_LANES", split_lanes)
        for target, sl, lanes, spec in cases:
            a = owalk.pack_walk(target, sl, lanes, **spec)
            assert (a.M > 0) == (split_lanes > 1) and a.value_bits == 64
            c, _ = ops.walk_lanes(target, sl, lanes, **spec)
            pc, _ = twalk.walk_lanes_plain(target, sl, lanes, **spec)
            assert torch.equal(c, pc) and int(c.sum()) > 0
            off = torch.cumsum(c, 0) - c
            for capacity in (int(c.sum()) + 5, int(c.sum()) * 2 // 3):
                assert torch.equal(
                    ops.walk_lanes(target, sl, lanes, capacity=capacity,
                                   offsets=off, **spec)[1],
                    twalk.walk_lanes_plain(target, sl, lanes,
                                           capacity=capacity, offsets=off,
                                           **spec)[1])
    for budget, per_lane in ((owalk.DFS_BUDGET, owalk.DFS_ITEMS_PER_LANE),
                             (2, 1)):
        monkeypatch.setattr(owalk, "DFS_BUDGET", budget)
        monkeypatch.setattr(owalk, "DFS_ITEMS_PER_LANE", per_lane)
        for b in (s64, b64, t32):
            sl = b.tree.levels // 2
            diag = torch.empty((owalk.pack_dfs(b, sl).K + 2, 4),
                               dtype=torch.int32, device=dev)
            c, _ = ops.dfs_lanes(b, sl, diag=diag)
            pc, _ = tdfs.dfs_lanes_plain(b, sl)
            assert torch.equal(c, pc)
            assert (int(diag[-1, 2]) > 0) == (per_lane == 1)   # in place
            off = torch.cumsum(c, 0) - c
            n = int(c.sum())
            for capacity in (n + 3, max(n // 2, 1)):
                assert torch.equal(
                    ops.dfs_lanes(b, sl, capacity, off)[1],
                    tdfs.dfs_lanes_plain(b, sl, capacity, off)[1])


@pytest.mark.gpu
def test_captured_dfs_replays_on_new_geometry():
    """DFS's count -> scan -> write makes no host sync on the card, is
    captured in a CUDA graph and replays on moved geometry (the BVH's
    tensors overwritten by another BVH of the same shape) equal to the
    eager call."""
    dev = card()
    b1 = port_bvh(1500, 35, scale=4.0, device=dev)
    moved = port_bvh(1500, 36, scale=4.0, device=dev)
    sl = b1.tree.levels // 2

    def run():
        c, _ = tdfs.dfs_single_fixed(b1, sl)
        off = torch.cumsum(c, 0) - c
        return c.sum(), tdfs.dfs_single_fixed(b1, sl, 1 << 14, off)[1]

    def tensors(b):
        return [b.skips, *b.nodes.los, *b.nodes.ups, *b.leaves.volume.xs,
                b.leaves.volume.r, b.leaves.index]

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
    assert ops.launch_count(ops.dfs_lanes) == 2
    g.replay()
    torch.cuda.synchronize()
    assert int(out[0]) == int(want[0]) > 0 and torch.equal(out[1], want[1])
    for s, f in zip(tensors(b1), tensors(moved), strict=True):
        s.copy_(f)
    g.replay()
    torch.cuda.synchronize()
    eager = run()
    assert int(out[0]) == int(eager[0]) != int(want[0])
    assert torch.equal(out[1], eager[1])
    g.reset()
