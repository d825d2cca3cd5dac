// W2: depth-first self-contact, each lane's stack split into work items in
// rounds, its row order kept.
//
// The port's kernel for the JAX package's device loop
// implicitbvh_tpu/traverse/dfs.py:57-141 (dfs_single_fixed, a
// lax.while_loop inside jax.jit; the JAX package has no Pallas kernel for
// it).  A lane is an initial pair (i1, i2) at start_level, unranked from
// its lane index as traverse/bfs.py:_initial_bvtt_single lists them, with
// its own stack of pending implicit pairs; it runs until the stack is
// empty, on the device: no host sync, and a CUDA graph captures the passes.
//
// A step repeats traverse/dfs.py's body: pop the top pair; at the leaf
// level a leaf-leaf test of a pair that is not a self pair, and in the write
// pass its sorted (min, max) user indices at the item's first row + its
// running count (dropped at or past the capacity); above it the node-pair
// test, then the 4-way push in the order ll, lr, rl, rr: ll on a self pair
// above the level over the leaves or a hit, lr on a self pair or a hit
// unless i2's right child is virtual, rl on a hit, rr as ll unless that
// child is virtual.  i1 < i2 in every pair check, so only i2's right child
// can be virtual.  Each pop that pushes removes one slot and adds at most
// four one level down, so `depth` = 3 (levels - start_level) + 4 slots
// suffice from any pair at or below the start level (MAX_DEPTH at most,
// which the wrapper checks).  Values are T, float or double (one BVH: one
// type), rounded one operation at a time by common.cuh's predicates.
//
// Bound on the H100: the latency of the longest chain of steps, each a
// pop, two dependent node loads and a test.  One thread per lane would
// last as long as the longest lane (38,662 steps at 1M leaves, a self pair
// whose subtree holds 2,048 leaves) while most lanes end early, so the
// work is split, exactly:
//   a work item is one pair of one lane; round 0's items are the lanes'
//     initial pairs (item k is lane k);
//   in rounds 0 .. R - 2 an item runs at most B steps; if its stack is not
//     empty then, it lists the stack's pairs, top to bottom, as new items
//     of its lane (its children, consecutive in the list), since DFS
//     finishes a popped pair's subtree before it pops the pair below: the
//     item's rows are its own steps' rows, then its children's rows in
//     order.  The list has a capacity fixed on the host; an item that
//     finds no room left runs on in place to its end, which is as exact
//     (no capacity can lose a row).  The last round runs each item to its
//     end.  The threads of a warp that list children together reserve
//     them with one atomic (reserve);
//   the count pass adds each item's rows to counts[lane] (integer atomics:
//     the sum does not depend on the order);
//   the write pass runs the same rounds, then sums each item's subtree of
//     items (dfs_total_kernel, last round to first), places round 0's
//     items at offsets[lane] and each child after its parent's own rows and
//     its earlier siblings' (dfs_place_kernel, first round to last), and
//     runs every item again from its pair with the same budget
//     (dfs_write_kernel), writing its rows there.
// B, R and the capacity are fixed from the shapes on the host
// (ops/walk.py: dfs_schedule), never from a count read back; the split of a
// lane depends on the lane, B and R only, so both passes split alike.
// Every grid is persistent (common.cuh: persistent_blocks) and takes its
// items from a counter (next_item), so no SM idles while items remain; a
// round's last block to finish records where the next round's items end.
// A thread's stack lives in shared memory, depth + 1 pairs a thread,
// strided by the block's threads (no bank conflicts), not in local
// memory; it costs occupancy (38 pairs at 1M leaves: 38 KB a block of 128
// threads, five blocks an SM).
#include <cooperative_groups.h>
#include <cooperative_groups/scan.h>
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

namespace {

using ibvh::BOX;
using ibvh::SPHERE;

constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 91;  // 3 (30 - 1) + 4: trees of up to 30 levels
constexpr int MAX_ROUNDS = 16;

struct Params {
  const void *nodes, *leaves, *leaf_index, *skips, *offsets;
  void *counts, *out;
  int* diag;
  // the work list: each item's pair and lane, its children (first, count;
  // 0 when it ran to its end), its own rows, its subtree's rows and its
  // first row (write pass)
  int2* pair;
  int *lane, *first, *nchild;
  long long *own, *total, *pos;
  // ctl: [0] the list's tail; [1 + r] the end of round r's items (r < R);
  // [R + 1 + r] the item counters of round r and (r = R) of the write run;
  // [2 R + 2 + r] the blocks done in round r
  int* ctl;
  int K, levels, virtual_leaves, num_nodes, num_leaves, depth, n, first_idx,
      budget, rounds, cap;
  long long capacity;
};

// Lane k's initial pair among the n nodes first, ..., first + n - 1 of the
// start level (traverse/bfs.py:_initial_bvtt_single): the n (n - 1) / 2
// pairs (i, j > i) in row order (utils.k2ij_exclusive: i is the largest in
// [0, max(n - 1, 1)) whose row starts at or before k, found by the same
// binary search), then the n self pairs (i, i).
__device__ __forceinline__ int2 initial_pair(long long k, int n, int first) {
  const long long pairs = (long long)n * (n - 1) / 2;
  if (k >= pairs) {
    const int s = first + (int)(k - pairs);
    return make_int2(s, s);
  }
  long long lo = 0, hi = max(n - 1, 1) - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (mid * (2LL * n - mid - 1) / 2 <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long j = lo + 1 + (k - lo * (2LL * n - lo - 1) / 2);
  return make_int2(first + (int)lo, first + (int)j);
}

// A thread's stack in the block's shared memory: slot s of thread t at
// s * THREADS + t.
struct Stack {
  int2* base;
  __device__ __forceinline__ int2& operator[](int s) const {
    return base[s * THREADS];
  }
};

// Runs the DFS on the stack's sp pairs for at most `budget` steps, adding
// the rows found to cnt (written at `base` + cnt in the write pass).
template <int NODE, int LEAF, typename T, typename I, bool WRITE, bool DIAG>
__device__ void run(const Params& p, const Stack& st, int& sp, int budget,
                    long long base, long long& cnt, ibvh::WalkCounts& d) {
  const T* nodes = (const T*)p.nodes;
  const T* leaves = (const T*)p.leaves;
  const I* __restrict__ skips = (const I*)p.skips;
  const int leaf_base = (1 << (p.levels - 1)) - 1;
  for (int steps = 0; sp > 0 && steps < budget; ++steps) {
    if constexpr (DIAG) ++d.steps;
    const int2 top = st[min(sp - 1, p.depth)];
    --sp;
    const bool is_self = top.x == top.y;
    const int i1 = max(top.x, 1), i2 = max(top.y, 1);
    const int level = 32 - __clz(i1);  // the pair's nodes share one level
    if (level == p.levels) {
      if (!is_self) {
        const int j1 = min(max(i1 - leaf_base - 1, 0), p.num_leaves - 1);
        const int j2 = min(max(i2 - leaf_base - 1, 0), p.num_leaves - 1);
        T a[6], b[6];
        ibvh::load_volume<LEAF>(leaves, j1, a);
        ibvh::load_volume<LEAF>(leaves, j2, b);
        if constexpr (DIAG) ++d.leaf_tests;
        if (ibvh::volumes_hit<LEAF, LEAF>(a, b)) {
          if constexpr (WRITE) {
            const long long pos = base + cnt;
            if (pos < p.capacity) {
              const I* leaf_index = (const I*)p.leaf_index;
              const long long x = (long long)leaf_index[j1];
              const long long y = (long long)leaf_index[j2];
              I* out = (I*)p.out;
              out[2 * pos] = (I)min(x, y);
              out[2 * pos + 1] = (I)max(x, y);
            }
          }
          ++cnt;
        }
      }
      continue;
    }
    bool hit = false;
    if (!is_self) {
      const int sk = (int)skips[level - 1];
      const int top_node = max(p.num_nodes, 1) - 1;
      const int m1 = min(max(i1 - sk - 1, 0), top_node);
      const int m2 = min(max(i2 - sk - 1, 0), top_node);
      T a[6], b[6];
      ibvh::load_volume<NODE>(nodes, m1, a);
      ibvh::load_volume<NODE>(nodes, m2, b);
      if constexpr (DIAG) ++d.node_tests;
      hit = ibvh::volumes_hit<NODE, NODE>(a, b);
    }
    // is i2's right child 2 i2 + 1 (on level + 1) virtual?
    const int first_next = 1 << level;
    const int nreal_next =
        first_next - (p.virtual_leaves >> (p.levels - (level + 1)));
    const bool virt2 = (2 * i2 + 1) - first_next + 1 > nreal_next;
    const bool self_down = is_self && level < p.levels - 1;
    const int l1 = 2 * i1, l2 = 2 * i2;
    const bool ok[4] = {self_down || hit, (is_self || hit) && !virt2, hit,
                        (self_down || hit) && !virt2};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // ll, lr, rl, rr
      if (ok[c]) {
        st[min(sp, p.depth)] = make_int2(l1 + (c >> 1), l2 + (c & 1));
        ++sp;
      }
    }
  }
}

// [lo, hi) of round r's items.
__device__ __forceinline__ void round_items(const Params& p, int r, int& lo,
                                            int& hi) {
  lo = r == 0 ? 0 : p.ctl[r];
  hi = p.ctl[1 + r];
}

// Reserves n >= 1 items at the list's tail (ctl[0]) for the calling
// thread, with one atomic for the threads of a warp that reserve together
// (a round's items end their steps at about the same time: one atomic an
// item would serialize them).  Returns the first item, or -1 when the
// list has no room for all n; the reservation that crosses the capacity
// marks its items below it as holes (lane -1), which the later kernels
// skip.  The tail stops growing once it reaches the capacity, so it
// passes it by at most the grid's threads times MAX_DEPTH.
__device__ int reserve(const Params& p, int n) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  const int before = cg::exclusive_scan(g, n);
  const int sum = g.shfl(before + n, (int)g.size() - 1);
  int base = p.cap;
  if (g.thread_rank() == 0 && *(volatile int*)p.ctl < p.cap)
    base = atomicAdd(p.ctl, sum);
  const long long start = (long long)g.shfl(base, 0) + before;
  if (start + n <= p.cap) return (int)start;
  for (long long i = start; i < p.cap; ++i) p.lane[i] = -1;
  return -1;
}

__global__ void dfs_init_kernel(Params p) {
  for (int i = threadIdx.x; i < 3 * p.rounds + 2; i += blockDim.x)
    p.ctl[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    p.ctl[0] = p.K;  // the tail: round 0's items are the K lanes
    p.ctl[1] = p.K;
  }
}

// Round r.  COUNT: the count pass (rows added to counts[lane]); else the
// write pass's counting rounds (own and total stored for the placing).
template <int NODE, int LEAF, typename T, typename I, bool COUNT, bool DIAG>
__global__ void __launch_bounds__(THREADS) dfs_round_kernel(Params p, int r) {
  extern __shared__ int2 stack_mem[];
  const Stack st{stack_mem + threadIdx.x};
  const bool last = r == p.rounds - 1;
  int lo, hi;
  round_items(p, r, lo, hi);
  for (int i = lo + ibvh::next_item(p.ctl + p.rounds + 1 + r); i < hi;
       i = lo + ibvh::next_item(p.ctl + p.rounds + 1 + r)) {
    int2 pr;
    int lane;
    if (r == 0) {
      pr = initial_pair(i, p.n, p.first_idx);
      lane = i;
      p.pair[i] = pr;
      p.lane[i] = i;
    } else {
      pr = p.pair[i];
      lane = p.lane[i];
      if (lane < 0) {  // a hole (see reserve): no item
        p.own[i] = 0;
        p.first[i] = 0;
        p.nchild[i] = 0;
        if constexpr (!COUNT) p.total[i] = 0;
        continue;
      }
    }
    st[0] = pr;
    int sp = 1;
    long long cnt = 0;
    ibvh::WalkCounts d;
    run<NODE, LEAF, T, I, false, DIAG>(p, st, sp, last ? INT_MAX : p.budget,
                                       0, cnt, d);
    int first = 0, nchild = 0;
    bool in_place = false;
    if (sp > 0) {  // list the stack's pairs as children, if they fit
      first = reserve(p, sp);
      if (first >= 0) {
        nchild = sp;
        for (int j = 0; j < sp; ++j) {  // top of the stack first
          p.pair[first + j] = st[sp - 1 - j];
          p.lane[first + j] = lane;
        }
      } else {  // no room: run on in place to the end
        first = 0;
        in_place = true;
        run<NODE, LEAF, T, I, false, DIAG>(p, st, sp, INT_MAX, 0, cnt, d);
      }
    }
    p.own[i] = cnt;
    p.first[i] = first;
    p.nchild[i] = nchild;
    if constexpr (COUNT) {
      if (cnt > 0) {
        if constexpr (sizeof(I) == 8)
          atomicAdd((unsigned long long*)p.counts + lane,
                    (unsigned long long)cnt);
        else
          atomicAdd((int*)p.counts + lane, (int)cnt);
      }
    } else {
      p.total[i] = cnt;
    }
    if constexpr (DIAG) ibvh::walk_diag(p.diag, p.K, lane, d, in_place);
  }
  if (!last) {  // the last block to finish ends round r + 1's items
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(p.ctl + 2 * p.rounds + 2 + r, 1) == (int)gridDim.x - 1)
        p.ctl[2 + r] = min(atomicAdd(p.ctl, 0), p.cap);
    }
  }
}

// The write pass, last round to first: an item's subtree rows are its own
// and its children's subtrees'.
__global__ void __launch_bounds__(THREADS) dfs_total_kernel(Params p, int r) {
  int lo, hi;
  round_items(p, r, lo, hi);
  for (int i = lo + blockIdx.x * THREADS + threadIdx.x; i < hi;
       i += gridDim.x * THREADS) {
    const int c0 = p.first[i], nc = p.nchild[i];
    if (nc == 0) continue;
    long long t = p.own[i];
    for (int c = c0; c < c0 + nc; ++c) t += p.total[c];
    p.total[i] = t;
  }
}

// The write pass, first round to last: round 0's item k at offsets[k]
// (counts[k] its subtree's rows); each child after its parent's own rows
// and its earlier siblings' subtrees.
template <typename I>
__global__ void __launch_bounds__(THREADS) dfs_place_kernel(Params p, int r) {
  int lo, hi;
  round_items(p, r, lo, hi);
  for (int i = lo + blockIdx.x * THREADS + threadIdx.x; i < hi;
       i += gridDim.x * THREADS) {
    if (r == 0) {
      p.pos[i] = (long long)((const I*)p.offsets)[i];
      ((I*)p.counts)[i] = (I)p.total[i];
    }
    const int c0 = p.first[i], nc = p.nchild[i];
    long long at = p.pos[i] + p.own[i];
    for (int c = c0; c < c0 + nc; ++c) {
      p.pos[c] = at;
      at += p.total[c];
    }
  }
}

// The write pass's last run: every item again from its pair, B steps if it
// listed children, else to its end, its rows at pos.
template <int NODE, int LEAF, typename T, typename I>
__global__ void __launch_bounds__(THREADS) dfs_write_kernel(Params p) {
  extern __shared__ int2 stack_mem[];
  const Stack st{stack_mem + threadIdx.x};
  const int n = min(p.ctl[0], p.cap);
  for (int i = ibvh::next_item(p.ctl + 2 * p.rounds + 1); i < n;
       i = ibvh::next_item(p.ctl + 2 * p.rounds + 1)) {
    if (p.lane[i] < 0) continue;  // a hole
    st[0] = p.pair[i];
    int sp = 1;
    long long cnt = 0;
    ibvh::WalkCounts d;
    run<NODE, LEAF, T, I, true, false>(p, st, sp,
                                       p.nchild[i] > 0 ? p.budget : INT_MAX,
                                       p.pos[i], cnt, d);
  }
}

template <typename Kern>
int grid_of(Kern kern, size_t shmem, long long items) {
  return ibvh::persistent_blocks(kern, THREADS, shmem,
                                 (items + THREADS - 1) / THREADS);
}

template <int NODE, int LEAF, typename T, typename I, bool DIAG>
void run_passes(const Params& p, bool write, cudaStream_t s) {
  const size_t shmem = (size_t)(p.depth + 1) * THREADS * sizeof(int2);
  dfs_init_kernel<<<1, 32, 0, s>>>(p);
  if (!write) cudaMemsetAsync(p.counts, 0, (size_t)p.K * sizeof(I), s);
  for (int r = 0; r < p.rounds; ++r) {
    const long long items = r == 0 ? p.K : p.cap;
    if (write) {
      auto k = dfs_round_kernel<NODE, LEAF, T, I, false, DIAG>;
      k<<<grid_of(k, shmem, items), THREADS, shmem, s>>>(p, r);
    } else {
      auto k = dfs_round_kernel<NODE, LEAF, T, I, true, DIAG>;
      k<<<grid_of(k, shmem, items), THREADS, shmem, s>>>(p, r);
    }
  }
  if (!write) return;
  const int tb = grid_of(dfs_total_kernel, 0, p.cap);
  for (int r = p.rounds - 2; r >= 0; --r)
    dfs_total_kernel<<<tb, THREADS, 0, s>>>(p, r);
  const int pb = grid_of(dfs_place_kernel<I>, 0, p.cap);
  for (int r = 0; r < max(p.rounds - 1, 1); ++r)
    dfs_place_kernel<I><<<pb, THREADS, 0, s>>>(p, r);
  auto w = dfs_write_kernel<NODE, LEAF, T, I>;
  w<<<grid_of(w, shmem, p.cap), THREADS, shmem, s>>>(p);
}

template <int NODE, int LEAF>
void run_typed(const Params& p, bool dbl, bool wide, bool write,
               cudaStream_t s) {
  const bool diag = p.diag != nullptr;
#define IBVH_DFS_RUN(T, I)                                  \
  diag ? run_passes<NODE, LEAF, T, I, true>(p, write, s) \
       : run_passes<NODE, LEAF, T, I, false>(p, write, s)
  if (dbl)
    wide ? IBVH_DFS_RUN(double, long long) : IBVH_DFS_RUN(double, int);
  else
    wide ? IBVH_DFS_RUN(float, long long) : IBVH_DFS_RUN(float, int);
#undef IBVH_DFS_RUN
}

}  // namespace

// nodes, leaves: records of the node and the leaf kind (4 or 8 values a
// row, as in walk.cu), float32 (value_bits 32) or float64 (64);
// leaf_index: (num_leaves,) I; skips: (levels,) I; offsets: (K,) I (write
// pass); counts: (K,) I; out: (max(capacity, 1), 2) I, zeroed; diag: (K +
// 2, 4) i32 (the diagnostic variant) or null.  The work list of `cap`
// items: pair (cap, 2) i32, lane, first, nchild (cap,) i32, own (cap,)
// i64, and in the write pass total and pos (cap,) i64; ctl: 3 rounds + 2
// i32.  node_kind, leaf_kind: 0 sphere, 1 box (sphere nodes over sphere
// leaves only); index_bits 32 or 64; 1 <= depth <= MAX_DEPTH; n and first:
// the start level's node count and first implicit index, K = n (n - 1) /
// 2, plus n above the leaf level; budget B >= 1, 1 <= rounds <=
// MAX_ROUNDS, K <= cap.
// Returns cudaGetLastError().
extern "C" int dfs_launch(const void* nodes, const void* leaves,
                          const void* leaf_index, const void* skips,
                          const void* offsets, void* counts, void* out,
                          void* diag, void* pair, void* lane, void* first,
                          void* nchild, void* own, void* total, void* pos,
                          void* ctl, int K, int node_kind, int leaf_kind,
                          int index_bits, int value_bits, int write,
                          int levels, int virtual_leaves, int num_nodes,
                          int num_leaves, int depth, int n, int first_idx,
                          int budget, int rounds, int cap,
                          long long capacity, void* stream) {
  if (K < 0 || levels < 1 || levels > 30 || num_leaves < 1 || depth < 1 ||
      depth > MAX_DEPTH || n < 1 || first_idx < 1 ||
      (index_bits != 32 && index_bits != 64) ||
      (value_bits != 32 && value_bits != 64) || budget < 1 || rounds < 1 ||
      rounds > MAX_ROUNDS || cap < K ||
      (write && (total == nullptr || pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (diag != nullptr) cudaMemsetAsync(diag, 0, (4LL * K + 8) * 4, s);
  const Params p{nodes,       leaves,        leaf_index,    skips,
                 offsets,     counts,        out,           (int*)diag,
                 (int2*)pair, (int*)lane,    (int*)first,   (int*)nchild,
                 (long long*)own, (long long*)total, (long long*)pos,
                 (int*)ctl,   K,             levels,        virtual_leaves,
                 num_nodes,   num_leaves,    depth,         n,
                 first_idx,   budget,        rounds,        cap,
                 capacity};
  const bool dbl = value_bits == 64, wide = index_bits == 64, wr = write != 0;
  if (node_kind == BOX && leaf_kind == SPHERE)
    run_typed<BOX, SPHERE>(p, dbl, wide, wr, s);
  else if (node_kind == BOX && leaf_kind == BOX)
    run_typed<BOX, BOX>(p, dbl, wide, wr, s);
  else if (node_kind == SPHERE && leaf_kind == SPHERE)
    run_typed<SPHERE, SPHERE>(p, dbl, wide, wr, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
