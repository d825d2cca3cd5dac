// W1: the stackless leaf-vs-tree walk, one thread per lane.
//
// The port's kernel for the JAX package's device loop
// implicitbvh_tpu/traverse/walk.py:35-141 (stackless_walk, a lax.while_loop
// inside jax.jit; the JAX package has no Pallas kernel for it).  Torch has no
// device-side loop, and a host loop over torch ops syncs to end.  Here each
// thread takes one lane (a leaf of the lanes' tree, or a ray) and loops
// until its implicit node index is 0, so the call makes no host sync and a
// CUDA graph captures it.  A lane's path through the tree depends on no
// other lane (the lockstep loop only decides when the whole loop ends), so
// the per-lane counts and the rows in order are the lockstep loop's.
//
// A step repeats traverse/walk.py:95-120: the level from the leading zeros;
// the virtual-sibling test and, for self-contact, the dedup prune (a subtree
// whose rightmost leaf is at or left of the lane's own leaf); at a node
// level the memory index cur - skips[level - 1] and the node test (descend
// to 2 cur on a hit); at the leaf level the leaf test and, in the write
// pass, the row at offsets[lane] + the lane's running count (dropped at or
// past the capacity); then the climb over trailing_ones(cur), capped at
// start_level (the forest of roots: an exhausted root steps to the next
// root, or to 0 after the last).  Implicit indices are int32 (at most 30
// levels); counts, offsets and rows are the index type I.
//
// The lane's volume is converted once to the node kind (a sphere lane's box
// for box nodes, volumes.bbox_of_bsphere rounded as there); a ray's 1 / d is
// an IEEE division and d.d a rounded sum, once per lane.  The predicates
// are common.cuh's, explicitly rounded, with the NaN rule of min2/max2.
//
// Bound on the H100: the latency of the longest lane.  A lane's steps are a
// chain of dependent loads (the next node depends on this node's test), so
// the call takes at least the longest lane's steps times a load's latency
// (L2 for the upper levels); the bytes (records read once, rows written
// once) and the tests' float operations are far below it.  This first
// kernel is simple: one thread per lane, records read through the
// read-only cache.  Shared memory for the top levels, warp-cooperative
// lanes and balancing long lanes across threads are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using ibvh::BOX;
using ibvh::SPHERE;

constexpr int THREADS = 128;
constexpr int LANE_RAY = 2;  // lane kinds: SPHERE, BOX (leaf lanes), rays

enum Emit : int { SELF = 0, PAIR = 1, PAIR_FLIPPED = 2, RAYS = 3 };

// A lane prepared once: a leaf lane's volume (v) and, for box nodes or box
// leaves, a sphere lane's box (box); a ray as (p, 1/d) for boxes and
// (p, d, d.d) for spheres.
template <int LANE>
struct Lane {
  float v[6];
  float box[6];
  float ray_box[6];
  float ray_sphere[7];
};

template <int LANE, int NODE, int LEAF>
__device__ __forceinline__ void prepare(const float4* __restrict__ lanes,
                                        int k, Lane<LANE>& q) {
  if constexpr (LANE == LANE_RAY) {
    const float4 a = __ldg(lanes + 2 * k);
    const float4 b = __ldg(lanes + 2 * k + 1);
    const float p[3] = {a.x, a.y, a.z}, d[3] = {a.w, b.x, b.y};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q.ray_box[c] = p[c];
      q.ray_box[3 + c] = __fdiv_rn(1.0f, d[c]);
      q.ray_sphere[c] = p[c];
      q.ray_sphere[3 + c] = d[c];
    }
    q.ray_sphere[6] = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]),
                                          __fmul_rn(d[1], d[1])),
                                __fmul_rn(d[2], d[2]));
  } else {
    ibvh::load_volume<LANE>(lanes, k, q.v);
    if constexpr (LANE == SPHERE && (NODE == BOX || LEAF == BOX))
      ibvh::box_of_sphere(q.v, q.box);
  }
}

// The node test (traverse/lvt.py: iscontact of the lane's node-kind volume;
// raytrace.py: isintersection).
template <int LANE, int NODE>
__device__ __forceinline__ bool node_hit(const Lane<LANE>& q, const float* n) {
  if constexpr (LANE == LANE_RAY) {
    if constexpr (NODE == BOX) return ibvh::ray_box_hit(q.ray_box, n);
    return ibvh::ray_sphere_hit(q.ray_sphere, n);
  } else if constexpr (NODE == SPHERE) {
    return ibvh::sphere_hit(q.v, n);  // sphere nodes take sphere lanes only
  } else if constexpr (LANE == SPHERE) {
    return ibvh::box_hit(q.box, n);
  } else {
    return ibvh::box_hit(q.v, n);
  }
}

// The leaf test: iscontact of the lane's own volume, a sphere against a box
// through the sphere's box; isintersection for rays.
template <int LANE, int LEAF>
__device__ __forceinline__ bool leaf_hit(const Lane<LANE>& q, const float* l) {
  if constexpr (LANE == LANE_RAY) {
    if constexpr (LEAF == BOX) return ibvh::ray_box_hit(q.ray_box, l);
    return ibvh::ray_sphere_hit(q.ray_sphere, l);
  } else if constexpr (LANE == SPHERE && LEAF == BOX) {
    return ibvh::box_hit(q.box, l);
  } else {
    return ibvh::volumes_hit<LANE, LEAF>(q.v, l);
  }
}

// One thread per lane k < K.  WRITE: the write pass (rows at offsets[k] +
// the running count, below `capacity`); else the count pass.  Both write
// counts[k].  DIAG, a diagnostic variant: `diag` gets each lane's steps,
// node tests and leaf tests (the other variants count nothing).
template <int LANE, int NODE, int LEAF, typename I, bool WRITE, bool DIAG>
__global__ void __launch_bounds__(THREADS) walk_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ leaves,
    const I* __restrict__ leaf_index, const I* __restrict__ skips,
    const float4* __restrict__ lanes, const I* __restrict__ lane_index,
    const I* __restrict__ dedup, const I* __restrict__ offsets,
    I* __restrict__ counts, I* __restrict__ out, int* __restrict__ diag,
    int K, int levels, int virtual_leaves, int num_nodes, int num_leaves,
    int start_level, int last_root, int emit, long long ray_offset,
    long long capacity) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  Lane<LANE> q;
  prepare<LANE, NODE, LEAF>(lanes, k, q);
  long long own = 0;  // the lane's user index, or its 1-based ray index
  if constexpr (LANE == LANE_RAY)
    own = ray_offset + k + 1;
  else
    own = (long long)lane_index[k];
  const long long prune = dedup != nullptr ? (long long)dedup[k] : -1;
  const long long base = WRITE ? (long long)offsets[k] : 0;
  const int leaf_base = (1 << (levels - 1)) - 1;

  long long cnt = 0;
  [[maybe_unused]] int steps = 0, node_tests = 0, leaf_tests = 0;
  int cur = 1 << (start_level - 1);
  while (cur > 0) {
    if constexpr (DIAG) ++steps;
    const int level = 32 - __clz(cur);
    const int level_first = 1 << (level - 1);
    const int nreal = level_first - (virtual_leaves >> (levels - level));
    bool skip = cur - level_first + 1 > nreal;  // a virtual right sibling
    if (((cur + 1) << (levels - level)) - 1 <= prune) skip = true;
    bool descend = false;
    if (!skip) {
      if (level < levels) {
        if (num_nodes > 0) {
          const int m =
              min(max(cur - (int)skips[level - 1] - 1, 0), num_nodes - 1);
          float n[6];
          ibvh::load_volume<NODE>(nodes, m, n);
          descend = node_hit<LANE, NODE>(q, n);
          if constexpr (DIAG) ++node_tests;
        }
      } else {
        const int j = min(max(cur - leaf_base - 1, 0), num_leaves - 1);
        float l[6];
        ibvh::load_volume<LEAF>(leaves, j, l);
        if constexpr (DIAG) ++leaf_tests;
        if (leaf_hit<LANE, LEAF>(q, l)) {
          if constexpr (WRITE) {
            const long long pos = base + cnt;
            if (pos < capacity) {
              const long long other = (long long)leaf_index[j];
              long long a = own, b = other;
              if (emit == SELF) {
                a = min(own, other);
                b = max(own, other);
              } else if (emit == PAIR_FLIPPED || emit == RAYS) {
                a = other;
                b = own;
              }
              out[2 * pos] = (I)a;
              out[2 * pos + 1] = (I)b;
            }
          }
          ++cnt;
        }
      }
    }
    if (descend) {
      cur = 2 * cur;
      continue;
    }
    // climb over the trailing ones, at most to the lane's root
    const int t = __ffs(cur + 1) - 1;
    const int depth = level - start_level;
    const int root = cur >> depth;
    if (t >= depth)
      cur = root + 1 > last_root ? 0 : root + 1;
    else
      cur = (cur >> t) + 1;
  }
  counts[k] = (I)cnt;
  if constexpr (DIAG) {
    diag[3 * k] = steps;
    diag[3 * k + 1] = node_tests;
    diag[3 * k + 2] = leaf_tests;
  }
}

struct Args {
  const void *nodes, *leaves, *leaf_index, *skips, *lanes, *lane_index,
      *dedup, *offsets;
  void *counts, *out, *diag;
  int K, levels, virtual_leaves, num_nodes, num_leaves, start_level,
      last_root, emit;
  long long ray_offset, capacity;
};

template <int LANE, int NODE, int LEAF, typename I, bool WRITE, bool DIAG>
void run(const Args& a, cudaStream_t stream) {
  const int blocks = (a.K + THREADS - 1) / THREADS;
  walk_kernel<LANE, NODE, LEAF, I, WRITE, DIAG>
      <<<blocks, THREADS, 0, stream>>>(
      (const float4*)a.nodes, (const float4*)a.leaves,
      (const I*)a.leaf_index, (const I*)a.skips, (const float4*)a.lanes,
      (const I*)a.lane_index, (const I*)a.dedup, (const I*)a.offsets,
      (I*)a.counts, (I*)a.out, (int*)a.diag, a.K, a.levels, a.virtual_leaves,
      a.num_nodes, a.num_leaves, a.start_level, a.last_root, a.emit,
      a.ray_offset, a.capacity);
}

template <int LANE, int NODE, int LEAF, typename I>
void run_passes(const Args& a, bool write, cudaStream_t s) {
  if (a.diag != nullptr)
    write ? run<LANE, NODE, LEAF, I, true, true>(a, s)
          : run<LANE, NODE, LEAF, I, false, true>(a, s);
  else
    write ? run<LANE, NODE, LEAF, I, true, false>(a, s)
          : run<LANE, NODE, LEAF, I, false, false>(a, s);
}

template <int LANE, int NODE, int LEAF>
void run_typed(const Args& a, bool wide, bool write, cudaStream_t s) {
  if (wide)
    run_passes<LANE, NODE, LEAF, long long>(a, write, s);
  else
    run_passes<LANE, NODE, LEAF, int>(a, write, s);
}

}  // namespace

// nodes: (num_nodes, 4 | 8) f32 records of the node kind; leaves:
// (num_leaves, 4 | 8) f32 records of the leaf kind; leaf_index:
// (num_leaves,) I; skips: (levels,) I; lanes: (K, 4 | 8) f32 records
// (a leaf lane's volume, or a ray (p0, p1, p2, d0, d1, d2, 0, 0)); lane_index:
// (K,) I (leaf lanes); dedup: (K,) I implicit leaf indices or null; offsets:
// (K,) I (write pass); counts: (K,) I; out: (capacity, 2) I, zeroed; diag:
// (K, 3) i32 (the diagnostic variant) or null.  lane_kind: 0 sphere, 1
// box, 2 ray; node_kind and leaf_kind: 0 sphere, 1 box (sphere nodes over
// sphere leaves only, and only with sphere or ray lanes); index_bits 32 or
// 64; emit: 0 self (min, max), 1 (lane, leaf), 2 (leaf, lane), 3 (leaf,
// ray_offset + k + 1).
// Returns cudaGetLastError().
extern "C" int walk_launch(const void* nodes, const void* leaves,
                           const void* leaf_index, const void* skips,
                           const void* lanes, const void* lane_index,
                           const void* dedup, const void* offsets,
                           void* counts, void* out, void* diag, int K,
                           int lane_kind, int node_kind, int leaf_kind,
                           int index_bits, int write, int levels,
                           int virtual_leaves, int num_nodes, int num_leaves,
                           int start_level, int last_root, int emit,
                           long long ray_offset, long long capacity,
                           void* stream) {
  if (K < 0 || levels < 1 || levels > 30 || start_level < 1 ||
      start_level > levels || num_leaves < 1 ||
      (index_bits != 32 && index_bits != 64) || emit < 0 || emit > 3)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const Args a{nodes,      leaves,         leaf_index, skips,      lanes,
               lane_index, dedup,          offsets,    counts,     out,
               diag,       K,              levels,     virtual_leaves,
               num_nodes,  num_leaves,     start_level, last_root, emit,
               ray_offset, capacity};
  const bool wide = index_bits == 64, wr = write != 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int combo = lane_kind * 4 + node_kind * 2 + leaf_kind;
  switch (combo) {
    case SPHERE * 4 + BOX * 2 + SPHERE:
      run_typed<SPHERE, BOX, SPHERE>(a, wide, wr, s);
      break;
    case SPHERE * 4 + BOX * 2 + BOX:
      run_typed<SPHERE, BOX, BOX>(a, wide, wr, s);
      break;
    case SPHERE * 4 + SPHERE * 2 + SPHERE:
      run_typed<SPHERE, SPHERE, SPHERE>(a, wide, wr, s);
      break;
    case BOX * 4 + BOX * 2 + SPHERE:
      run_typed<BOX, BOX, SPHERE>(a, wide, wr, s);
      break;
    case BOX * 4 + BOX * 2 + BOX:
      run_typed<BOX, BOX, BOX>(a, wide, wr, s);
      break;
    case LANE_RAY * 4 + BOX * 2 + SPHERE:
      run_typed<LANE_RAY, BOX, SPHERE>(a, wide, wr, s);
      break;
    case LANE_RAY * 4 + BOX * 2 + BOX:
      run_typed<LANE_RAY, BOX, BOX>(a, wide, wr, s);
      break;
    case LANE_RAY * 4 + SPHERE * 2 + SPHERE:
      run_typed<LANE_RAY, SPHERE, SPHERE>(a, wide, wr, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
