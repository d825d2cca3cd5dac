// L1: the tile engine's W-grouping of a ti-sorted list (leader packing).
//
// Replaces no TPU kernel.  The JAX package computes this grouping in XLA
// glue, jax.lax.cummax and two cumsums (implicitbvh_tpu/traverse/tiles.py:
// 346-360, _leader_group), and no Pallas kernel stands behind it; the
// port's torch-op version of the chain (ops/grouping.py:
// leader_group_plain) runs its scan with indices over every padded entry in
// one block.  This kernel gives the plain version's outputs bit for bit.
//
// The function.  Entry i of a list of E entries sorted by ti starts a
// segment when its ti differs from entry i-1's (entry 0's from -1, the
// plain version's sentinel), valid or not.  posr_i counts the valid entries
// of i's segment before it; a valid entry with posr_i % W == 0 is a leader,
// and gid_i is the number of leaders up to and including i, less 1.  The
// leader of group gid writes its ti (as int32) to a_idx[gid], and payload q
// of a valid entry goes to grouped[q][gid*W + posr_i % W]; writes with gid
// outside [0, S_cap) are dropped.  Slots that nothing writes hold 0 (a_idx)
// or the payload's pad, and nsteps is the leader count, uncapped.
//
// The scan.  Counted a segment at a time, the leaders are an associative
// scan.  A run of entries is summed up as a carry (c, head, closed, tail):
// whether it holds a segment start; its valid entries before its first
// start; the leaders of the segments that it closes, ceil(n / W) for a
// segment of n valid entries; and its valid entries from its last start on
// (head == tail and closed == 0 in a run without a start).  A then B:
//   B without a start: (A.c, A.head + (A.c ? 0 : B.head), A.closed,
//                       A.tail + B.head);
//   B with one, A without: (1, A.head + B.head, B.closed, B.tail);
//   both with one: (1, A.head, A.closed + ceil((A.tail + B.head) / W)
//                   + B.closed, B.tail).
// Every prefix starts from (1, 0, -1, 1): a segment of one phantom valid
// entry that is not a leader, which the sentinel closes unless entry 0's ti
// is -1 (then the plain version's posr counts it too).  For a valid entry i
// with exclusive prefix P: posr_i = c_i ? 0 : P.tail and gid_i = P.closed +
// (c_i ? ceil(P.tail / W) : 0) + posr_i / W; nsteps = closed + ceil(tail /
// W) of the whole list.
//
// Two launches on the caller's stream, nothing allocated, no host sync, so
// a CUDA graph captures them.
// - leader_tile_kernel sums each tile of 256 x ITEMS entries (a thread's
//   ITEMS consecutive entries, then a block scan of the carries by warp
//   shuffles) into one carry in the scratch, and the whole grid fills the
//   outputs with 0 and the pads.
// - leader_scan_kernel, a block a tile: the block combines the carries of
//   the tiles before its own (at most a few hundred, read from L2), scans
//   its tile again, writes each leader's ti, and keeps each entry's slot in
//   shared memory; then the k payload rows move in coalesced order, entry
//   e of the tile by thread e % 256.  The last tile writes nsteps.
// ITEMS is 4: the main path's lists (65,536 to 1,048,576 entries at the
// cells' starting capacities) take 64 to 1,024 tiles, and a block of the
// scan pass combines the carries before its tile, ceil(tiles / 256) a
// thread.  16 entries a thread took 1.8-2.3x the time up to 144,384 entries
// and 5% more at 1,048,576 (PERF.md, L1).
//
// Bound on the H100: bytes.  ti, the valid flags and the k payloads are
// read and the outputs (a_idx, k rows of S_cap * W slots, nsteps) written:
// at the ray regroup's 1,048,576 entries (int32 ti, one int64 payload) and
// S_cap 81,920 x W 8 slots, 4.2 + 1.0 + 8.4 MB read and 0.3 + 2.6 MB
// written, about 16.6 MB, 0.005 ms at 3.35 TB/s.  There is no
// arithmetic to speak of; the design reads each input in one pass (ti and
// the flags twice, the second time mostly from L2) and writes each output
// slot twice at most (the fill, then the entry).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;

// The payload rows: a base pointer, an element stride, int64 or int32
// elements (an int64 is taken as its low 32 bits), and the pad.
struct Rows {
  const void* p[MAX_K];
  long long stride[MAX_K];
  int wide[MAX_K];
  int pad[MAX_K];
};

struct Carry {
  int c, head, closed, tail;
};

__device__ __forceinline__ Carry identity() { return {0, 0, 0, 0}; }
// the prefix before entry 0 (see the note)
__device__ __forceinline__ Carry phantom() { return {1, 0, -1, 1}; }

__device__ __forceinline__ int ceil_div(int x, int w) {
  return (x + w - 1) / w;
}

__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b,
                                         int W) {
  if (!b.c) return {a.c, a.c ? a.head : a.head + b.head, a.closed,
                    a.tail + b.head};
  if (!a.c) return {1, a.head + b.head, b.closed, b.tail};
  return {1, a.head, a.closed + ceil_div(a.tail + b.head, W) + b.closed,
          b.tail};
}

// One entry as a carry: c its start flag, v its valid flag.
__device__ __forceinline__ Carry entry(int c, int v) {
  return {c, c ? 0 : v, 0, v};
}

__device__ __forceinline__ Carry shfl_up(const Carry& x, int d) {
  return {__shfl_up_sync(FULL, x.c, d), __shfl_up_sync(FULL, x.head, d),
          __shfl_up_sync(FULL, x.closed, d), __shfl_up_sync(FULL, x.tail, d)};
}

// The block's exclusive scan of one carry a thread, in thread order;
// *total gets the whole block's.  sh holds WARPS + 1 carries.
__device__ __forceinline__ Carry block_scan(const Carry& x, int W, Carry* sh,
                                            Carry* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Carry inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Carry y = shfl_up(inc, o);
    if (lane >= o) inc = combine(y, inc, W);
  }
  Carry ex = shfl_up(inc, 1);
  if (lane == 0) ex = identity();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Carry w = lane < WARPS ? sh[lane] : identity();
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const Carry y = shfl_up(w, o);
      if (lane >= o) w = combine(y, w, W);
    }
    Carry we = shfl_up(w, 1);
    if (lane == 0) we = identity();
    if (lane < WARPS) sh[lane] = we;
    if (lane == WARPS - 1) sh[WARPS] = w;
  }
  __syncthreads();
  *total = sh[WARPS];
  const Carry r = combine(sh[warp], ex, W);
  __syncthreads();  // sh is free for the next scan
  return r;
}

// The start and valid flags of entries first .. first + ITEMS - 1 (bit j
// for entry first + j; 0 past E).
template <typename T>
__device__ __forceinline__ void load_flags(const T* __restrict__ ti,
                                           const uint8_t* __restrict__ valid,
                                           int E, int first, unsigned* cm,
                                           unsigned* vm) {
  *cm = *vm = 0;
  if (first >= E) return;
  T prev = first == 0 ? (T)-1 : ti[first - 1];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = first + j;
    if (i < E) {
      const T t = ti[i];
      *cm |= (unsigned)(t != prev) << j;
      *vm |= (unsigned)(valid[i] != 0) << j;
      prev = t;
    }
  }
}

__device__ __forceinline__ Carry sum_flags(unsigned cm, unsigned vm, int W) {
  Carry x = identity();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    x = combine(x, entry((cm >> j) & 1u, (vm >> j) & 1u), W);
  return x;
}

// Blocks below ntiles: their tile's carry into aggs.  Every block: its
// share of the fill (out: S_cap zeros, then k rows of sw pads).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    leader_tile_kernel(const T* __restrict__ ti,
                       const uint8_t* __restrict__ valid, int E, int W,
                       int ntiles, int4* __restrict__ aggs,
                       int* __restrict__ out, int S_cap, long long sw, int k,
                       Rows rows) {
  __shared__ Carry sh[WARPS + 1];
  if ((int)blockIdx.x < ntiles) {
    const int first = blockIdx.x * TILE + threadIdx.x * ITEMS;
    unsigned cm, vm;
    load_flags<T>(ti, valid, E, first, &cm, &vm);
    Carry total;
    block_scan(sum_flags(cm, vm, W), W, sh, &total);
    if (threadIdx.x == 0)
      aggs[blockIdx.x] = make_int4(total.c, total.head, total.closed,
                                   total.tail);
  }
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)gridDim.x * THREADS;
  for (long long m = tid; m < S_cap; m += nthr) out[m] = 0;
  for (int q = 0; q < k; ++q) {
    int* row = out + S_cap + q * sw;
    const int pad = rows.pad[q];
    for (long long m = tid; m < sw; m += nthr) row[m] = pad;
  }
}

__device__ __forceinline__ int payload(const Rows& rows, int q, int e) {
  const long long at = (long long)e * rows.stride[q];
  return rows.wide[q] ? (int)static_cast<const long long*>(rows.p[q])[at]
                      : static_cast<const int*>(rows.p[q])[at];
}

// Block b: tile b's leaders and payloads; the last block writes nsteps.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    leader_scan_kernel(const T* __restrict__ ti,
                       const uint8_t* __restrict__ valid, int E, int W,
                       const int4* __restrict__ aggs, int* __restrict__ out,
                       int S_cap, long long sw, int k, Rows rows) {
  __shared__ Carry sh[WARPS + 1];
  __shared__ int slot[TILE];
  const int b = blockIdx.x;

  // the carry of the tiles before this one, thread t combining a run of
  // them in order
  const int per = (b + THREADS - 1) / THREADS;
  Carry x = identity();
  const int j_end = min(b, ((int)threadIdx.x + 1) * per);
  for (int j = threadIdx.x * per; j < j_end; ++j) {
    const int4 a = aggs[j];
    x = combine(x, {a.x, a.y, a.z, a.w}, W);
  }
  Carry before;
  block_scan(x, W, sh, &before);

  const int base = b * TILE;
  const int first = base + threadIdx.x * ITEMS;
  unsigned cm, vm;
  load_flags<T>(ti, valid, E, first, &cm, &vm);
  Carry tile_total;
  const Carry ex = block_scan(sum_flags(cm, vm, W), W, sh,
                              &tile_total);
  Carry pre = combine(combine(phantom(), before, W), ex, W);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int c = (cm >> j) & 1u, v = (vm >> j) & 1u;
    int s = -1;
    if (v) {
      const int posr = c ? 0 : pre.tail;
      const int gid = pre.closed + (c ? ceil_div(pre.tail, W) : 0) +
                      posr / W;
      if (gid >= 0 && gid < S_cap) {
        const int r = posr % W;
        s = gid * W + r;
        if (r == 0) out[gid] = (int)ti[first + j];
      }
    }
    slot[threadIdx.x * ITEMS + j] = s;
    pre = combine(pre, entry(c, v), W);
  }
  // the last thread's carry now spans the whole list
  if (b == (int)gridDim.x - 1 && threadIdx.x == THREADS - 1)
    out[S_cap + k * sw] = pre.closed + ceil_div(pre.tail, W);
  __syncthreads();

  const int n = min(TILE, E - base);
  for (int q = 0; q < k; ++q) {
    int* row = out + S_cap + q * sw;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const int s = slot[e];
      if (s >= 0) row[s] = payload(rows, q, base + e);
    }
  }
}

template <typename T>
int launch(const void* ti, const void* valid, int E, int W, int S_cap, int k,
           const Rows& rows, void* out, void* scratch, cudaStream_t stream) {
  const int ntiles = (E + TILE - 1) / TILE;
  const long long sw = (long long)S_cap * W;
  // the fill: about 16 slots a thread, at most 8 blocks an SM of 132
  const long long fill = S_cap + k * sw;
  const long long fill_blocks =
      std::min((fill + 16LL * THREADS - 1) / (16LL * THREADS), 1056LL);
  const int grid = (int)std::max((long long)ntiles, fill_blocks);
  leader_tile_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)ti, (const uint8_t*)valid, E, W, ntiles, (int4*)scratch,
      (int*)out, S_cap, sw, k, rows);
  leader_scan_kernel<T><<<ntiles, THREADS, 0, stream>>>(
      (const T*)ti, (const uint8_t*)valid, E, W, (const int4*)scratch,
      (int*)out, S_cap, sw, k, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// ti: (E,) int32 (ti_bytes 4) or int64 (8), contiguous; valid: (E,) bool as
// bytes; payload q: E elements at rows[q] with element stride strides[q],
// int64 where wide[q] else int32; pads: k ints.  out: S_cap + k * S_cap *
// W + 1 ints, a_idx, the k grouped rows and nsteps, nothing zeroed; scratch:
// 16-byte aligned, 4 * ceil(E / 1024) ints.  Needs E >= 1, W >= 1, S_cap
// >= 1, 1 <= k <= 32 and (k + 1) * S_cap * W < 2^31.  Two launches on the
// stream.  Returns cudaGetLastError().
extern "C" int leader_group_launch(const void* ti, int ti_bytes,
                                   const void* valid, const void* const* rows,
                                   const long long* strides, const int* wide,
                                   const int* pads, int k, int E, int W,
                                   int S_cap, void* out, void* scratch,
                                   void* stream) {
  if (E < 1 || W < 1 || S_cap < 1 || k < 1 || k > MAX_K ||
      (ti_bytes != 4 && ti_bytes != 8) || ((size_t)scratch & 15) != 0 ||
      (long long)(k + 1) * S_cap * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Rows r{};
  for (int q = 0; q < k; ++q) {
    r.p[q] = rows[q];
    r.stride[q] = strides[q];
    r.wide[q] = wide[q];
    r.pad[q] = pads[q];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (ti_bytes == 4)
    return launch<int>(ti, valid, E, W, S_cap, k, r, out, scratch, s);
  return launch<long long>(ti, valid, E, W, S_cap, k, r, out, scratch, s);
}
