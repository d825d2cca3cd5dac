// Mega-tile stream compaction with tile and row caps.
//
// Replaces implicitbvh_tpu/ops/compaction.py:tile_compact (_compact_kernel)
// and, through compact_flat_launch, tile_compact and finish_compact
// together.  The flat mask is cut into mega-tiles of 128 rows x 128 lanes.
// In mega-tile t the s-th survivor of row r (s < row_cap) goes to slot
// row_off[r] + s when that slot is below cap, row_off being the exclusive
// prefix of the uncapped row counts; counts[t] is the uncapped total and
// over[t] is set when it exceeds cap or a row exceeds row_cap.
//
// One block of 32 warps per mega-tile, each warp owning four rows.  A warp
// reads a row as four 32-lane ballots (one coalesced 32-byte load each) and
// keeps the ballots in registers; __popc gives the row count and, masked
// below the lane, each survivor's in-row rank.  Warp 0 scans the 128 row
// counts (four per lane), then each warp writes its kept survivors.  The TPU
// kernel's one-hot matmuls and slot loop disappear.
//
// compact_launch (tile_compact) writes the padded (2, tiles, cap) slots,
// zeroed by the caller.  compact_flat_launch writes the flat lists that
// finish_compact makes of them, with no slot arrays, in two launches: a
// count pass (the same kernel without its writes) gives counts[t]; then
// each block of the write pass sums min(counts, cap) over the mega-tiles
// before its own for its base in the flat list (a few hundred counts, read
// from L2) and writes every kept survivor straight to base + slot, zeroes
// the slots that a row over row_cap leaves empty, and with the rest of the
// grid zeroes the lists past the grand total; positions at or past the
// capacity are dropped.  Block 0 writes the total and the overflow flag.
// So the outputs need no zeroing, and the wrapper makes one allocation.
//
// Bound on the H100: bytes.  The mask is read once per pass and only the
// survivors' payloads are gathered; the outputs are the largest write.
// There is no arithmetic to speak of, so the design reads the mask in
// coalesced warp-wide loads and keeps it in registers as ballots between
// the count and the write.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 128;
constexpr int LANES = 128;
constexpr int WARPS = 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr unsigned FULL = 0xffffffffu;

// The row ballots of the warp's four rows of mega-tile t, and their counts
// in row_cnt (shared).
__device__ __forceinline__ void row_ballots(const uint8_t* __restrict__ mask,
                                            size_t base, int warp, int lane,
                                            unsigned (&bits)[ROWS_PER_WARP][4],
                                            int* row_cnt) {
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int r = warp + WARPS * q;
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool v = mask[base + (size_t)r * LANES + 32 * k + lane] != 0;
      bits[q][k] = __ballot_sync(FULL, v);
      c += __popc(bits[q][k]);
    }
    if (lane == 0) row_cnt[r] = c;
  }
}

// Warp 0: the exclusive prefix of the 128 row counts into row_off; returns
// the tile's total in every lane and its largest row count in *mx.
__device__ __forceinline__ int scan_rows(const int* row_cnt, int* row_off,
                                         int lane, int* mx_out) {
  int c[4], s = 0, mx = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // lane l scans rows 4l .. 4l+3
    c[i] = row_cnt[4 * lane + i];
    s += c[i];
    mx = max(mx, c[i]);
  }
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  int o = x - s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_off[4 * lane + i] = o;
    o += c[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(FULL, mx, off));
  *mx_out = mx;
  return __shfl_sync(FULL, x, 31);
}

// tile_compact's kernel; without WRITE the count pass of compact_flat
// (counts and over only).
template <bool WRITE>
__global__ void __launch_bounds__(WARPS * 32)
    compact_kernel(const uint8_t* __restrict__ mask,
                   const int* __restrict__ p0, const int* __restrict__ p1,
                   int* __restrict__ slots, int* __restrict__ counts,
                   int* __restrict__ over, int cap, int row_cap,
                   size_t plane) {
  __shared__ int row_cnt[ROWS];
  __shared__ int row_off[ROWS];
  __shared__ int total_sh;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)t * ROWS * LANES;

  unsigned bits[ROWS_PER_WARP][4];
  row_ballots(mask, base, warp, lane, bits, row_cnt);
  __syncthreads();

  if (warp == 0) {
    int mx;
    const int total = scan_rows(row_cnt, row_off, lane, &mx);
    if (lane == 0) {
      counts[t] = total;
      over[t] = (total > cap) || (mx > row_cap);
      total_sh = total;
    }
  }
  if constexpr (!WRITE) return;
  __syncthreads();
  if (total_sh == 0) return;

#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int r = warp + WARPS * q;
    const int off = row_off[r];
    int prefix = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned b = bits[q][k];
      if ((b >> lane) & 1u) {
        const int rank = prefix + __popc(b & ((1u << lane) - 1u));
        if (rank < row_cap && off + rank < cap) {
          const size_t idx = base + (size_t)r * LANES + 32 * k + lane;
          const size_t slot = (size_t)t * cap + off + rank;
          slots[slot] = p0[idx];
          slots[plane + slot] = p1[idx];
        }
      }
      prefix += __popc(b);
    }
  }
}

// compact_flat's write pass: block t writes mega-tile t's kept survivors at
// base + slot of out (two lists of `capacity` ints, one after the other),
// base being the sum of min(counts, cap) over the mega-tiles before t, and
// zeroes the slots of its rows over row_cap; the grid zeroes both lists
// from the grand total on.  res: the total, then the overflow flag.
__global__ void __launch_bounds__(WARPS * 32)
    compact_flat_kernel(const uint8_t* __restrict__ mask,
                        const int* __restrict__ p0,
                        const int* __restrict__ p1,
                        const int* __restrict__ counts,
                        const int* __restrict__ over, int* __restrict__ out,
                        int* __restrict__ res, int tiles, int cap,
                        int row_cap, int capacity) {
  __shared__ int row_cnt[ROWS];
  __shared__ int row_off[ROWS];
  __shared__ int red[3][WARPS];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)t * ROWS * LANES;

  unsigned bits[ROWS_PER_WARP][4];
  row_ballots(mask, base, warp, lane, bits, row_cnt);

  // the tile's base, the grand total and the overflow flag, from the
  // counts of every mega-tile
  long long before = 0, all = 0;
  int ov = 0;
  for (int u = threadIdx.x; u < tiles; u += blockDim.x) {
    const int c = min(counts[u], cap);
    if (u < t) before += c;
    all += c;
    ov |= over[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(FULL, before, o);
    all += __shfl_xor_sync(FULL, all, o);
    ov |= __shfl_xor_sync(FULL, ov, o);
  }
  if (lane == 0) {  // both sums are at most the mask's length M < 2^31
    red[0][warp] = (int)before;
    red[1][warp] = (int)all;
    red[2][warp] = ov;
  }
  __syncthreads();
  if (warp == 0) {
    int mx;
    scan_rows(row_cnt, row_off, lane, &mx);
    int b = red[0][lane], a = red[1][lane], v = red[2][lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      b += __shfl_xor_sync(FULL, b, o);
      a += __shfl_xor_sync(FULL, a, o);
      v |= __shfl_xor_sync(FULL, v, o);
    }
    if (lane == 0) {
      red[0][0] = b;
      red[1][0] = a;
      if (t == 0) {
        res[0] = a;
        res[1] = v != 0;
      }
    }
  }
  __syncthreads();
  const long long tile_base = red[0][0];
  const long long total = red[1][0];

#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int r = warp + WARPS * q;
    const int off = row_off[r];
    int prefix = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned b = bits[q][k];
      if ((b >> lane) & 1u) {
        const int rank = prefix + __popc(b & ((1u << lane) - 1u));
        const long long pos = tile_base + off + rank;
        if (rank < row_cap && off + rank < cap && pos < capacity) {
          const size_t idx = base + (size_t)r * LANES + 32 * k + lane;
          out[pos] = p0[idx];
          out[capacity + pos] = p1[idx];
        }
      }
      prefix += __popc(b);
    }
    // a row over row_cap leaves its slots past row_cap empty: zeros
    const int end = min(off + row_cnt[r], cap);
    for (int s = off + row_cap + lane; s < end; s += 32) {
      const long long pos = tile_base + s;
      if (pos < capacity) {
        out[pos] = 0;
        out[capacity + pos] = 0;
      }
    }
  }
  // both lists past the grand total
  if (total < capacity) {
    ibvh::grid_zero(out, total, capacity);
    ibvh::grid_zero(out, capacity + total, 2LL * capacity);
  }
}

}  // namespace

// mask: (tiles*16384,) bool as bytes; p0, p1: (tiles*16384,) i32 payloads;
// slots: (2, tiles, cap) i32, zeroed by the caller; counts, over: (tiles,)
// i32.  Returns cudaGetLastError().
extern "C" int compact_launch(const void* mask, const void* p0, const void* p1,
                              void* slots, void* counts, void* over, int tiles,
                              int cap, int row_cap, void* stream) {
  if (tiles < 0 || cap <= 0 || row_cap <= 0) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    compact_kernel<true><<<tiles, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (const int*)p0, (const int*)p1, (int*)slots,
        (int*)counts, (int*)over, cap, row_cap, (size_t)tiles * (size_t)cap);
  }
  return (int)cudaGetLastError();
}

// mask, p0, p1 as above; out: (2 * capacity,) i32, the two flat lists one
// after the other, 16-byte aligned; res: (2 * tiles + 2,) i32 scratch and
// results: the per-tile counts and flags, then the grand total (may exceed
// capacity) and the overflow flag.  Nothing needs zeroing.  Two launches
// on the stream.  Returns cudaGetLastError().
extern "C" int compact_flat_launch(const void* mask, const void* p0,
                                   const void* p1, void* out, void* res,
                                   int tiles, int cap, int row_cap,
                                   int capacity, void* stream) {
  if (tiles <= 0 || cap <= 0 || row_cap <= 0 || capacity <= 0 ||
      ((size_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int* counts = (int*)res;
  int* over = counts + tiles;
  compact_kernel<false><<<tiles, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)p0, (const int*)p1, nullptr, counts,
      over, cap, row_cap, 0);
  compact_flat_kernel<<<tiles, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int*)p0, (const int*)p1, counts, over,
      (int*)out, over + tiles, tiles, cap, row_cap, capacity);
  return (int)cudaGetLastError();
}
