// W1: the stackless leaf-vs-tree walk, long lanes split by subtree.
//
// The port's kernel for the JAX package's device loop
// implicitbvh_tpu/traverse/walk.py:35-141 (stackless_walk, a lax.while_loop
// inside jax.jit; the JAX package has no Pallas kernel for it).  Torch has no
// device-side loop, and a host loop over torch ops syncs to end.  Here the
// lanes (leaves of the lanes' tree, or rays) run on the device until each
// is done, so the call makes no host sync and a CUDA graph captures it.  A
// lane's path through the tree depends on no other lane (the lockstep loop
// only decides when the whole loop ends), so the per-lane counts and the
// rows in order are the lockstep loop's.
//
// A step repeats traverse/walk.py:95-120: the level from the leading zeros;
// the virtual-sibling test and, for self-contact, the dedup prune (a subtree
// whose rightmost leaf is at or left of the lane's own leaf); at a node
// level the memory index cur - skips[level - 1] and the node test (descend
// to 2 cur on a hit); at the leaf level the leaf test and, in the write
// pass, the row at the lane's offset + its running count (dropped at or
// past the capacity); then the climb over trailing_ones(cur), capped at the
// roots' level (the forest of roots: an exhausted root steps to the next
// root, or to 0 after the last).  Implicit indices are int32 (at most 30
// levels); counts, offsets and rows are the index type I.
//
// Values are T, float or double, as ops/walk.py packs the records: the
// wider of the lanes' and the tree's types (rays have the tree's).  A
// lane's volume is converted once to the node kind (a sphere lane's box,
// volumes.bbox_of_bsphere rounded as there); a ray's 1 / d is an IEEE
// division and d.d a rounded sum, once per lane.  A sphere's box, a
// one-sided operation, is rounded in the sphere's own type (a float32 side
// of a double walk: `lane_single`, `tree_single`), as torch and JAX
// compute it before promoting.  The predicates are common.cuh's,
// explicitly rounded, with the NaN rule of min2/max2.
//
// Bound on the H100: the latency of the longest chain of steps.  A lane's
// steps are a chain of dependent loads (the next node depends on this
// node's test), and one thread per lane leaves the call as long as its
// longest lane, with most SMs idle when the lanes are few (1,000 rays fill
// 8 of the 132 SMs).  So with few lanes (K < 4,096, ops/walk.py:
// split_level) the walk is split by subtree at a level s below the start
// level, and its order kept:
//   stage 1 (walk_roots_kernel, one thread per lane) walks from the start
//     level down to level s with the node tests and the dedup prune and
//     marks each level-s root it reaches in the lane's slots (M a lane,
//     one per level-s node under the start level's roots, in root order);
//   stage 2 (walk_kernel, a persistent grid taking slots from a counter)
//     walks each reached root's subtree, its climb capped at s as the
//     forest's is at the start level, and counts its rows;
//   walk_scan_kernel (a warp a lane) sums the slots of each lane in root
//     order into counts[k] and, in the write pass, places each slot's rows
//     at offsets[k] + the rows of the lane's earlier slots;
//   the write pass runs stage 2 again, writing each slot's rows there.
// A lane's walk visits its level-s subtrees in root order and all leaves
// lie on the last level, so the rows of its slots in slot order are its
// rows in order.  s and M are fixed from K and the tree's levels alone.
// With K >= 4,096 lanes (s = the start level) walk_kernel runs one thread
// per lane to its end in one launch.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using ibvh::BOX;
using ibvh::SPHERE;

constexpr int THREADS = 128;
constexpr int LANE_RAY = 2;  // lane kinds: SPHERE, BOX (leaf lanes), rays

enum Emit : int { SELF = 0, PAIR = 1, PAIR_FLIPPED = 2, RAYS = 3 };

struct Params {
  const void *nodes, *leaves, *leaf_index, *skips, *lanes, *lane_index,
      *dedup, *offsets;
  void *counts, *out;
  int* diag;
  long long* slot_own;  // (K, M): -1 unreached, else the slot's rows
  long long* slot_pos;  // (K, M): the slot's first row (write pass)
  int* work;            // two item counters of stage 2
  int K, levels, virtual_leaves, num_nodes, num_leaves, start_level,
      last_root, emit, split, M, lane_single, tree_single;
  long long ray_offset, capacity;
};

// a - b and a + b rounded in float when `single` (a float32 side of a
// double walk), else in T.
template <typename T>
__device__ __forceinline__ T sub_side(T a, T b, bool single) {
  if constexpr (std::is_same_v<T, double>)
    if (single) return (double)__fsub_rn((float)a, (float)b);
  return ibvh::sub_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T add_side(T a, T b, bool single) {
  if constexpr (std::is_same_v<T, double>)
    if (single) return (double)__fadd_rn((float)a, (float)b);
  return ibvh::add_rn(a, b);
}

// A sphere's box in its own type (volumes.bbox_of_bsphere).
template <typename T>
__device__ __forceinline__ void sphere_box(const T* s, T* b, bool single) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = sub_side(s[k], s[3], single);
    b[3 + k] = add_side(s[k], s[3], single);
  }
}

// A lane prepared once: a leaf lane's volume (v) and, for box nodes or box
// leaves, a sphere lane's box (box); a ray as (p, 1/d) for boxes and
// (p, d, d.d) for spheres.
template <int LANE, typename T>
struct Lane {
  T v[6];
  T box[6];
  T ray_box[6];
  T ray_sphere[7];
};

template <int LANE, int NODE, int LEAF, typename T>
__device__ __forceinline__ void prepare(const Params& p, int k,
                                        Lane<LANE, T>& q) {
  const T* lanes = (const T*)p.lanes;
  if constexpr (LANE == LANE_RAY) {
    T r[6];  // a ray's record is a box's: (p0, p1, p2, d0 | d1, d2, 0, 0)
    ibvh::load_volume<BOX>(lanes, k, r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q.ray_box[c] = r[c];
      q.ray_box[3 + c] = ibvh::div_rn(T(1), r[3 + c]);
      q.ray_sphere[c] = r[c];
      q.ray_sphere[3 + c] = r[3 + c];
    }
    q.ray_sphere[6] =
        ibvh::add_rn(ibvh::add_rn(ibvh::mul_rn(r[3], r[3]),
                                  ibvh::mul_rn(r[4], r[4])),
                     ibvh::mul_rn(r[5], r[5]));
  } else {
    ibvh::load_volume<LANE>(lanes, k, q.v);
    if constexpr (LANE == SPHERE && (NODE == BOX || LEAF == BOX))
      sphere_box(q.v, q.box, p.lane_single != 0);
  }
}

// The node test (traverse/lvt.py: iscontact of the lane's node-kind volume;
// raytrace.py: isintersection).
template <int LANE, int NODE, typename T>
__device__ __forceinline__ bool node_hit(const Lane<LANE, T>& q,
                                         const T* n) {
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
template <int LANE, int LEAF, typename T>
__device__ __forceinline__ bool leaf_hit(const Lane<LANE, T>& q, const T* l,
                                         bool tree_single) {
  if constexpr (LANE == LANE_RAY) {
    if constexpr (LEAF == BOX) return ibvh::ray_box_hit(q.ray_box, l);
    return ibvh::ray_sphere_hit(q.ray_sphere, l);
  } else if constexpr (LANE == SPHERE && LEAF == BOX) {
    return ibvh::box_hit(q.box, l);
  } else if constexpr (LANE == BOX && LEAF == SPHERE) {
    T lb[6];
    sphere_box(l, lb, tree_single);
    return ibvh::box_hit(q.v, lb);
  } else {
    return ibvh::volumes_hit<LANE, LEAF>(q.v, l);
  }
}

// The level's virtual-sibling test and the dedup prune.
__device__ __forceinline__ bool skipped(const Params& p, int cur, int level,
                                        long long prune) {
  const int level_first = 1 << (level - 1);
  const int nreal = level_first - (p.virtual_leaves >> (p.levels - level));
  return cur - level_first + 1 > nreal ||
         ((cur + 1) << (p.levels - level)) - 1 <= prune;
}

// The climb over the trailing ones of cur, capped at level `top` and at
// the root `last`: the next node to visit, or 0.
__device__ __forceinline__ int climb(int cur, int level, int top, int last) {
  const int t = __ffs(cur + 1) - 1;
  const int depth = level - top;
  const int root = cur >> depth;
  if (t >= depth) return root + 1 > last ? 0 : root + 1;
  return (cur >> t) + 1;
}

// Walks lane k (prepared as q) from `cur` until it is done, the climb
// capped at level `top` and at the root `last`; in the write pass its rows
// go to `base` + the running count.  Returns the rows found.
template <int LANE, int NODE, int LEAF, typename T, typename I, bool WRITE,
          bool DIAG>
__device__ long long walk(const Params& p, const Lane<LANE, T>& q,
                          long long own, long long prune, int cur, int top,
                          int last, long long base, ibvh::WalkCounts& d) {
  const I* __restrict__ skips = (const I*)p.skips;
  const int leaf_base = (1 << (p.levels - 1)) - 1;
  long long cnt = 0;
  while (cur > 0) {
    if constexpr (DIAG) ++d.steps;
    const int level = 32 - __clz(cur);
    const bool skip = skipped(p, cur, level, prune);
    bool descend = false;
    if (!skip) {
      if (level < p.levels) {
        if (p.num_nodes > 0) {
          const int m =
              min(max(cur - (int)skips[level - 1] - 1, 0), p.num_nodes - 1);
          T n[6];
          ibvh::load_volume<NODE>((const T*)p.nodes, m, n);
          descend = node_hit<LANE, NODE>(q, n);
          if constexpr (DIAG) ++d.node_tests;
        }
      } else {
        const int j = min(max(cur - leaf_base - 1, 0), p.num_leaves - 1);
        T l[6];
        ibvh::load_volume<LEAF>((const T*)p.leaves, j, l);
        if constexpr (DIAG) ++d.leaf_tests;
        if (leaf_hit<LANE, LEAF>(q, l, p.tree_single != 0)) {
          if constexpr (WRITE) {
            const long long pos = base + cnt;
            if (pos < p.capacity) {
              const long long other = (long long)((const I*)p.leaf_index)[j];
              long long a = own, b = other;
              if (p.emit == SELF) {
                a = min(own, other);
                b = max(own, other);
              } else if (p.emit == PAIR_FLIPPED || p.emit == RAYS) {
                a = other;
                b = own;
              }
              I* out = (I*)p.out;
              out[2 * pos] = (I)a;
              out[2 * pos + 1] = (I)b;
            }
          }
          ++cnt;
        }
      }
    }
    cur = descend ? 2 * cur : climb(cur, level, top, last);
  }
  return cnt;
}

template <int LANE, typename I>
__device__ __forceinline__ long long own_index(const Params& p, int k) {
  if constexpr (LANE == LANE_RAY) return p.ray_offset + k + 1;
  return (long long)((const I*)p.lane_index)[k];
}

template <typename I>
__device__ __forceinline__ long long prune_of(const Params& p, int k) {
  return p.dedup != nullptr ? (long long)((const I*)p.dedup)[k] : -1;
}

// The first level-s node under the start level's first root.
__device__ __forceinline__ int first_slot_node(const Params& p) {
  return (1 << (p.start_level - 1)) << (p.split - p.start_level);
}

// p.M == 0: one thread per lane, walked from the start level to its end
// (counts[k]; the write pass writes its rows at offsets[k]).  Else stage 2:
// a persistent grid takes the slots from p.work[WRITE] and walks each
// reached root's subtree (the count run stores its rows in slot_own; the
// write run writes them at slot_pos).
template <int LANE, int NODE, int LEAF, typename T, typename I, bool WRITE,
          bool DIAG>
__global__ void __launch_bounds__(THREADS) walk_kernel(Params p) {
  if (p.M == 0) {
    const int k = blockIdx.x * THREADS + threadIdx.x;
    if (k >= p.K) return;
    Lane<LANE, T> q;
    prepare<LANE, NODE, LEAF>(p, k, q);
    ibvh::WalkCounts d;
    const long long base = WRITE ? (long long)((const I*)p.offsets)[k] : 0;
    const long long cnt = walk<LANE, NODE, LEAF, T, I, WRITE, DIAG>(
        p, q, own_index<LANE, I>(p, k), prune_of<I>(p, k),
        1 << (p.start_level - 1), p.start_level, p.last_root, base, d);
    ((I*)p.counts)[k] = (I)cnt;
    if constexpr (DIAG) ibvh::walk_diag(p.diag, p.K, k, d, false);
    return;
  }
  const long long n = (long long)p.K * p.M;
  const int root0 = first_slot_node(p);
  for (long long i = ibvh::next_item(p.work + WRITE); i < n;
       i = ibvh::next_item(p.work + WRITE)) {
    if (p.slot_own[i] < 0) continue;  // not reached in stage 1
    const int k = (int)(i / p.M);
    const int root = root0 + (int)(i - (long long)k * p.M);
    Lane<LANE, T> q;
    prepare<LANE, NODE, LEAF>(p, k, q);
    ibvh::WalkCounts d;
    const long long cnt = walk<LANE, NODE, LEAF, T, I, WRITE, DIAG>(
        p, q, own_index<LANE, I>(p, k), prune_of<I>(p, k), root, p.split,
        root, WRITE ? p.slot_pos[i] : 0, d);
    if constexpr (!WRITE) p.slot_own[i] = cnt;
    if constexpr (DIAG) ibvh::walk_diag(p.diag, p.K, k, d, false);
  }
}

// Stage 1: one thread per lane walks from the start level down to level
// p.split, with the node tests and the dedup prune above it, and marks
// each level-split root it reaches (slot_own 0; the rest stay -1).
template <int LANE, int NODE, int LEAF, typename T, typename I, bool DIAG>
__global__ void __launch_bounds__(THREADS) walk_roots_kernel(Params p) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= p.K) return;
  Lane<LANE, T> q;
  prepare<LANE, NODE, LEAF>(p, k, q);
  const long long prune = prune_of<I>(p, k);
  const I* __restrict__ skips = (const I*)p.skips;
  long long* own = p.slot_own + (long long)k * p.M;
  const int root0 = first_slot_node(p);
  ibvh::WalkCounts d;
  int cur = 1 << (p.start_level - 1);
  while (cur > 0) {
    if constexpr (DIAG) ++d.steps;
    const int level = 32 - __clz(cur);
    bool descend = false;
    if (!skipped(p, cur, level, prune)) {
      if (level == p.split) {
        own[cur - root0] = 0;  // an item of stage 2
      } else {  // a node level: split <= levels, so num_nodes > 0
        const int m =
            min(max(cur - (int)skips[level - 1] - 1, 0), p.num_nodes - 1);
        T n[6];
        ibvh::load_volume<NODE>((const T*)p.nodes, m, n);
        descend = node_hit<LANE, NODE>(q, n);
        if constexpr (DIAG) ++d.node_tests;
      }
    }
    cur = descend ? 2 * cur : climb(cur, level, p.start_level, p.last_root);
  }
  if constexpr (DIAG) ibvh::walk_diag(p.diag, p.K, k, d, false);
}

// A warp per lane: counts[k] = the sum of the lane's slots, and in the
// write pass slot_pos = offsets[k] + the rows of the lane's earlier slots
// (root order).
template <typename I, bool WRITE>
__global__ void __launch_bounds__(THREADS) walk_scan_kernel(Params p) {
  const long long w = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= p.K) return;  // whole warps
  const int k = (int)w;
  const long long* own = p.slot_own + (long long)k * p.M;
  long long run = WRITE ? (long long)((const I*)p.offsets)[k] : 0;
  const long long start = run;
  for (int j0 = 0; j0 < p.M; j0 += 32) {
    const int j = j0 + lane;
    const long long v = j < p.M ? max(own[j], 0LL) : 0;
    long long x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (WRITE && j < p.M) p.slot_pos[(long long)k * p.M + j] = run + x - v;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) ((I*)p.counts)[k] = (I)(run - start);
}

template <int LANE, int NODE, int LEAF, typename T, typename I, bool DIAG>
void run_split(const Params& p, bool write, cudaStream_t s) {
  const int lane_blocks = (p.K + THREADS - 1) / THREADS;
  const long long slots = (long long)p.K * p.M;
  cudaMemsetAsync(p.slot_own, 0xff, slots * sizeof(long long), s);
  cudaMemsetAsync(p.work, 0, 2 * sizeof(int), s);
  walk_roots_kernel<LANE, NODE, LEAF, T, I, DIAG>
      <<<lane_blocks, THREADS, 0, s>>>(p);
  auto count = walk_kernel<LANE, NODE, LEAF, T, I, false, DIAG>;
  const long long item_blocks = (slots + THREADS - 1) / THREADS;
  count<<<ibvh::persistent_blocks(count, THREADS, 0, item_blocks), THREADS,
          0, s>>>(p);
  const int scan_blocks = (int)((32LL * p.K + THREADS - 1) / THREADS);
  if (write) {
    walk_scan_kernel<I, true><<<scan_blocks, THREADS, 0, s>>>(p);
    // the write run repeats the count run's walks: its counters would
    // count them twice
    auto wr = walk_kernel<LANE, NODE, LEAF, T, I, true, false>;
    wr<<<ibvh::persistent_blocks(wr, THREADS, 0, item_blocks), THREADS, 0,
         s>>>(p);
  } else {
    walk_scan_kernel<I, false><<<scan_blocks, THREADS, 0, s>>>(p);
  }
}

template <int LANE, int NODE, int LEAF, typename T, typename I, bool DIAG>
void run_diag(const Params& p, bool write, cudaStream_t s) {
  if (p.M > 0) return run_split<LANE, NODE, LEAF, T, I, DIAG>(p, write, s);
  const int blocks = (p.K + THREADS - 1) / THREADS;
  if (write)
    walk_kernel<LANE, NODE, LEAF, T, I, true, DIAG>
        <<<blocks, THREADS, 0, s>>>(p);
  else
    walk_kernel<LANE, NODE, LEAF, T, I, false, DIAG>
        <<<blocks, THREADS, 0, s>>>(p);
}

template <int LANE, int NODE, int LEAF>
void run_typed(const Params& p, bool dbl, bool wide, bool write,
               cudaStream_t s) {
  const bool diag = p.diag != nullptr;
#define IBVH_WALK_RUN(T, I)                                \
  diag ? run_diag<LANE, NODE, LEAF, T, I, true>(p, write, s) \
       : run_diag<LANE, NODE, LEAF, T, I, false>(p, write, s)
  if (dbl)
    wide ? IBVH_WALK_RUN(double, long long) : IBVH_WALK_RUN(double, int);
  else
    wide ? IBVH_WALK_RUN(float, long long) : IBVH_WALK_RUN(float, int);
#undef IBVH_WALK_RUN
}

}  // namespace

// nodes: (num_nodes, 4 | 8) records of the node kind; leaves: (num_leaves,
// 4 | 8) records of the leaf kind; lanes: (K, 4 | 8) records (a leaf lane's
// volume, or a ray (p0, p1, p2, d0, d1, d2, 0, 0)), all float32 (value_bits
// 32) or all float64 (64); lane_single / tree_single: the lanes' / the
// tree's own type is float32 in a float64 walk.  leaf_index: (num_leaves,)
// I; skips: (levels,) I; lane_index: (K,) I (leaf lanes); dedup: (K,) I
// implicit leaf indices or null; offsets: (K,) I (write pass); counts: (K,)
// I; out: (capacity, 2) I, zeroed; diag: (K + 2, 4) i32 (the diagnostic
// variant) or null.  split: the level s of stage 1's roots, M the slots a
// lane (0: one stage); slot_own, slot_pos: (K * M,) i64 (slot_pos in the
// write pass), work: 2 i32, or null with M = 0.  lane_kind: 0 sphere, 1
// box, 2 ray; node_kind and leaf_kind: 0 sphere, 1 box (sphere nodes over
// sphere leaves only, and only with sphere or ray lanes); index_bits 32 or
// 64; emit: 0 self (min, max), 1 (lane, leaf), 2 (leaf, lane), 3 (leaf,
// ray_offset + k + 1).
// Returns cudaGetLastError().
extern "C" int walk_launch(const void* nodes, const void* leaves,
                           const void* leaf_index, const void* skips,
                           const void* lanes, const void* lane_index,
                           const void* dedup, const void* offsets,
                           void* counts, void* out, void* diag,
                           void* slot_own, void* slot_pos, void* work, int K,
                           int lane_kind, int node_kind, int leaf_kind,
                           int index_bits, int value_bits, int lane_single,
                           int tree_single, int write, int levels,
                           int virtual_leaves, int num_nodes, int num_leaves,
                           int start_level, int last_root, int emit,
                           int split, int M, long long ray_offset,
                           long long capacity, void* stream) {
  if (K < 0 || levels < 1 || levels > 30 || start_level < 1 ||
      start_level > levels || num_leaves < 1 ||
      (index_bits != 32 && index_bits != 64) ||
      (value_bits != 32 && value_bits != 64) || emit < 0 || emit > 3 ||
      M < 0 || (M > 0 && (split <= start_level || split > levels ||
                          slot_own == nullptr || work == nullptr ||
                          (write && slot_pos == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (diag != nullptr) cudaMemsetAsync(diag, 0, (4LL * K + 8) * 4, s);
  const Params p{nodes,       leaves,        leaf_index,
                 skips,       lanes,         lane_index,
                 dedup,       offsets,       counts,
                 out,         (int*)diag,    (long long*)slot_own,
                 (long long*)slot_pos, (int*)work, K,
                 levels,      virtual_leaves, num_nodes,
                 num_leaves,  start_level,   last_root,
                 emit,        split,         M,
                 lane_single, tree_single,   ray_offset,
                 capacity};
  const bool dbl = value_bits == 64, wide = index_bits == 64, wr = write != 0;
  const int combo = lane_kind * 4 + node_kind * 2 + leaf_kind;
  switch (combo) {
    case SPHERE * 4 + BOX * 2 + SPHERE:
      run_typed<SPHERE, BOX, SPHERE>(p, dbl, wide, wr, s);
      break;
    case SPHERE * 4 + BOX * 2 + BOX:
      run_typed<SPHERE, BOX, BOX>(p, dbl, wide, wr, s);
      break;
    case SPHERE * 4 + SPHERE * 2 + SPHERE:
      run_typed<SPHERE, SPHERE, SPHERE>(p, dbl, wide, wr, s);
      break;
    case BOX * 4 + BOX * 2 + SPHERE:
      run_typed<BOX, BOX, SPHERE>(p, dbl, wide, wr, s);
      break;
    case BOX * 4 + BOX * 2 + BOX:
      run_typed<BOX, BOX, BOX>(p, dbl, wide, wr, s);
      break;
    case LANE_RAY * 4 + BOX * 2 + SPHERE:
      run_typed<LANE_RAY, BOX, SPHERE>(p, dbl, wide, wr, s);
      break;
    case LANE_RAY * 4 + BOX * 2 + BOX:
      run_typed<LANE_RAY, BOX, BOX>(p, dbl, wide, wr, s);
      break;
    case LANE_RAY * 4 + SPHERE * 2 + SPHERE:
      run_typed<LANE_RAY, SPHERE, SPHERE>(p, dbl, wide, wr, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
