// W2: depth-first self-contact, one thread per initial BVTT pair.
//
// The port's kernel for the JAX package's device loop
// implicitbvh_tpu/traverse/dfs.py:57-141 (dfs_single_fixed, a
// lax.while_loop inside jax.jit; the JAX package has no Pallas kernel for
// it).  Each thread takes one lane, an initial pair (i1, i2) at start_level,
// which it unranks from its lane index as traverse/bfs.py:
// _initial_bvtt_single lists them, and runs its own stack of pending
// implicit pairs until the stack is empty: no host sync, and a CUDA graph
// captures it.  A lane's stack depends on no other lane, so the per-lane
// counts and the rows in order are the lockstep loop's.
//
// A step repeats traverse/dfs.py's body: pop the top pair; at the leaf
// level a leaf-leaf test of a pair that is not a self pair, and in the write
// pass its sorted (min, max) user indices at offsets[lane] + the running
// count (dropped at or past the capacity); above it the node-pair test, then
// the 4-way push in the order ll, lr, rl, rr: ll on a self pair above the
// level over the leaves or a hit, lr on a self pair or a hit unless i2's
// right child is virtual, rl on a hit, rr as ll unless that child is
// virtual.  i1 < i2 in every pair check, so only i2's right child can be
// virtual.  Each pop that pushes removes one slot and adds at most four one
// level down, so `depth` = 3 (levels - start_level) + 4 slots suffice; the
// stack lives in the thread's local memory, MAX_DEPTH slots at most, which
// the wrapper checks.
//
// Bound on the H100: the latency of the longest lane, whose steps are a
// chain of dependent loads (pop, the two nodes, the test, the push); the
// bytes and the float operations are far below it.  This first kernel is
// simple: one thread per lane, the stack in local memory.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ibvh::BOX;
using ibvh::SPHERE;

constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 91;  // 3 (30 - 1) + 4: trees of up to 30 levels

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

// One thread per lane k < K, whose initial pair is initial_pair(k, n,
// first).  WRITE: the write pass; else the count pass.  Both write
// counts[k].  DIAG, a diagnostic variant: `diag` gets each lane's steps,
// node-pair tests and leaf-pair tests (the other variants count nothing).
template <int NODE, int LEAF, typename I, bool WRITE, bool DIAG>
__global__ void __launch_bounds__(THREADS) dfs_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ leaves,
    const I* __restrict__ leaf_index, const I* __restrict__ skips,
    const I* __restrict__ offsets, I* __restrict__ counts,
    I* __restrict__ out, int* __restrict__ diag, int K, int levels,
    int virtual_leaves, int num_nodes, int num_leaves, int depth, int n,
    int first, long long capacity) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const int leaf_base = (1 << (levels - 1)) - 1;
  const long long base = WRITE ? (long long)offsets[k] : 0;
  // slot `depth` takes the pushes past the stack, as the plain version's
  // one extra slot does (never reached: see above)
  int2 st[MAX_DEPTH + 1];
  st[0] = initial_pair(k, n, first);
  int sp = 1;
  long long cnt = 0;
  [[maybe_unused]] int steps = 0, node_tests = 0, leaf_tests = 0;
  while (sp > 0) {
    if constexpr (DIAG) ++steps;
    const int2 top = st[min(sp - 1, depth)];
    --sp;
    const bool is_self = top.x == top.y;
    const int i1 = max(top.x, 1), i2 = max(top.y, 1);
    const int level = 32 - __clz(i1);  // the pair's nodes share one level
    if (level == levels) {
      if (!is_self) {
        const int j1 = min(max(i1 - leaf_base - 1, 0), num_leaves - 1);
        const int j2 = min(max(i2 - leaf_base - 1, 0), num_leaves - 1);
        float a[6], b[6];
        ibvh::load_volume<LEAF>(leaves, j1, a);
        ibvh::load_volume<LEAF>(leaves, j2, b);
        if constexpr (DIAG) ++leaf_tests;
        if (ibvh::volumes_hit<LEAF, LEAF>(a, b)) {
          if constexpr (WRITE) {
            const long long pos = base + cnt;
            if (pos < capacity) {
              const long long x = (long long)leaf_index[j1];
              const long long y = (long long)leaf_index[j2];
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
      const int top_node = max(num_nodes, 1) - 1;
      const int m1 = min(max(i1 - sk - 1, 0), top_node);
      const int m2 = min(max(i2 - sk - 1, 0), top_node);
      float a[6], b[6];
      ibvh::load_volume<NODE>(nodes, m1, a);
      ibvh::load_volume<NODE>(nodes, m2, b);
      if constexpr (DIAG) ++node_tests;
      hit = ibvh::volumes_hit<NODE, NODE>(a, b);
    }
    // is i2's right child 2 i2 + 1 (on level + 1) virtual?
    const int first_next = 1 << level;
    const int nreal_next =
        first_next - (virtual_leaves >> (levels - (level + 1)));
    const bool virt2 = (2 * i2 + 1) - first_next + 1 > nreal_next;
    const bool self_down = is_self && level < levels - 1;
    const int l1 = 2 * i1, l2 = 2 * i2;
    const bool ok[4] = {self_down || hit, (is_self || hit) && !virt2, hit,
                        (self_down || hit) && !virt2};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // ll, lr, rl, rr
      if (ok[c]) {
        st[min(sp, depth)] = make_int2(l1 + (c >> 1), l2 + (c & 1));
        ++sp;
      }
    }
  }
  counts[k] = (I)cnt;
  if constexpr (DIAG) {
    diag[3 * k] = steps;
    diag[3 * k + 1] = node_tests;
    diag[3 * k + 2] = leaf_tests;
  }
}

struct Args {
  const void *nodes, *leaves, *leaf_index, *skips, *offsets;
  void *counts, *out, *diag;
  int K, levels, virtual_leaves, num_nodes, num_leaves, depth, n, first;
  long long capacity;
};

template <int NODE, int LEAF, typename I, bool WRITE, bool DIAG>
void run(const Args& a, cudaStream_t stream) {
  const int blocks = (a.K + THREADS - 1) / THREADS;
  dfs_kernel<NODE, LEAF, I, WRITE, DIAG><<<blocks, THREADS, 0, stream>>>(
      (const float4*)a.nodes, (const float4*)a.leaves,
      (const I*)a.leaf_index, (const I*)a.skips, (const I*)a.offsets,
      (I*)a.counts, (I*)a.out, (int*)a.diag, a.K, a.levels,
      a.virtual_leaves, a.num_nodes, a.num_leaves, a.depth, a.n, a.first,
      a.capacity);
}

template <int NODE, int LEAF, typename I>
void run_passes(const Args& a, bool write, cudaStream_t s) {
  if (a.diag != nullptr)
    write ? run<NODE, LEAF, I, true, true>(a, s)
          : run<NODE, LEAF, I, false, true>(a, s);
  else
    write ? run<NODE, LEAF, I, true, false>(a, s)
          : run<NODE, LEAF, I, false, false>(a, s);
}

template <int NODE, int LEAF>
void run_typed(const Args& a, bool wide, bool write, cudaStream_t s) {
  if (wide)
    run_passes<NODE, LEAF, long long>(a, write, s);
  else
    run_passes<NODE, LEAF, int>(a, write, s);
}

}  // namespace

// nodes, leaves: f32 records of the node and the leaf kind (4 or 8 floats
// a row, as in walk.cu); leaf_index: (num_leaves,) I; skips: (levels,) I;
// offsets: (K,) I (write pass); counts: (K,) I; out: (max(capacity, 1), 2)
// I, zeroed; diag: (K, 3) i32 (the diagnostic variant) or null.
// node_kind, leaf_kind: 0 sphere, 1 box (sphere nodes over sphere leaves
// only); index_bits 32 or 64;
// 1 <= depth <= MAX_DEPTH; n and first: the start level's node count and
// first implicit index, K = n (n - 1) / 2, plus n above the leaf level.
// Returns cudaGetLastError().
extern "C" int dfs_launch(const void* nodes, const void* leaves,
                          const void* leaf_index, const void* skips,
                          const void* offsets, void* counts, void* out,
                          void* diag, int K, int node_kind, int leaf_kind,
                          int index_bits, int write, int levels,
                          int virtual_leaves, int num_nodes, int num_leaves,
                          int depth, int n, int first, long long capacity,
                          void* stream) {
  if (K < 0 || levels < 1 || levels > 30 || num_leaves < 1 || depth < 1 ||
      depth > MAX_DEPTH || n < 1 || first < 1 ||
      (index_bits != 32 && index_bits != 64))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const Args a{nodes, leaves, leaf_index, skips, offsets, counts, out, diag,
               K, levels, virtual_leaves, num_nodes, num_leaves, depth, n,
               first, capacity};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wide = index_bits == 64, wr = write != 0;
  if (node_kind == BOX && leaf_kind == SPHERE)
    run_typed<BOX, SPHERE>(a, wide, wr, s);
  else if (node_kind == BOX && leaf_kind == BOX)
    run_typed<BOX, BOX>(a, wide, wr, s);
  else if (node_kind == SPHERE && leaf_kind == SPHERE)
    run_typed<SPHERE, SPHERE>(a, wide, wr, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
