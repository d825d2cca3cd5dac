// Mega-tile stream compaction with tile and row caps.
//
// Replaces implicitbvh_tpu/ops/compaction.py:tile_compact (_compact_kernel).
// The flat mask is cut into mega-tiles of 128 rows x 128 lanes.  In
// mega-tile t the s-th survivor of row r (s < row_cap) goes to slot
// row_off[r] + s when that slot is below cap, row_off being the exclusive
// prefix of the uncapped row counts; counts[t] is the uncapped total and
// over[t] is set when it exceeds cap or a row exceeds row_cap.  The caller
// zeroes the slots (unwritten slots hold 0, as the TPU kernel's
// accumulators start at zero).
//
// One block of 32 warps per mega-tile, each warp owning four rows.  A warp
// reads a row as four 32-lane ballots (one coalesced 32-byte load each) and
// keeps the ballots in registers; __popc gives the row count and, masked
// below the lane, each survivor's in-row rank.  Warp 0 scans the 128 row
// counts (four per lane), then each warp writes its kept survivors.  The TPU
// kernel's one-hot matmuls and slot loop disappear.
//
// Bound on the H100: bytes.  The mask is read once and only the survivors'
// payloads are gathered; the slot arrays (zeroed by the wrapper) are the
// largest write.  There is no arithmetic to speak of, so the design reads
// the mask in coalesced warp-wide loads and keeps it in registers as
// ballots between the count and the write pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;
constexpr int LANES = 128;
constexpr int WARPS = 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr unsigned FULL = 0xffffffffu;

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
  __syncthreads();

  if (warp == 0) {  // lane l scans rows 4l .. 4l+3
    int c[4], s = 0, mx = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    const int total = __shfl_sync(FULL, x, 31);
    if (lane == 0) {
      counts[t] = total;
      over[t] = (total > cap) || (mx > row_cap);
      total_sh = total;
    }
  }
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

}  // namespace

// mask: (tiles*16384,) bool as bytes; p0, p1: (tiles*16384,) i32 payloads;
// slots: (2, tiles, cap) i32, zeroed by the caller; counts, over: (tiles,)
// i32.  Returns cudaGetLastError().
extern "C" int compact_launch(const void* mask, const void* p0, const void* p1,
                              void* slots, void* counts, void* over, int tiles,
                              int cap, int row_cap, void* stream) {
  if (tiles < 0 || cap <= 0 || row_cap <= 0) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    compact_kernel<<<tiles, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)mask, (const int*)p0, (const int*)p1, (int*)slots,
        (int*)counts, (int*)over, cap, row_cap, (size_t)tiles * (size_t)cap);
  }
  return (int)cudaGetLastError();
}
