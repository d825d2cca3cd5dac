// Exact contact counts of every (step, w, t) tile pair of the run list.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_run_counts
// (_run_count_kernel, _acols, _band_mask) on its sphere and box masks.
// Block (s, w) takes a-tile a_idx[s] against the R b-tiles of the aligned
// run run_idx[s*W+w]; one thread per b-column j.  For each tile t whose NB
// band bits are not all zero, the thread loops over the a-rows of the live
// bands only (the dead bands are skipped exactly as the bits say: band
// skipping is part of the result) and counts its column's contacts, with
// the j > i dedup on the diagonal pair.  A block reduction writes the
// pair's count and its largest column count (colmax) straight to the
// reduced (S_cap*W*R,) outputs: no per-lane plane is materialised.  Slots
// with s >= min(nsteps, S_cap) (read on the device) write zeros.
//
// Bound on the H100: operations.  The work is num_checks leaf tests of
// ~11 flops (sphere) each against a few hundred MB of traffic at most; the
// a-tile sits in shared memory (read once per block, broadcast to all
// threads), each b-leaf in registers, and dead tiles and bands cost only a
// branch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

template <bool BOX>
__global__ void run_counts_kernel(const int* __restrict__ a_idx,
                                  const int* __restrict__ run_idx,
                                  const int* __restrict__ bm,
                                  const int* __restrict__ nsteps,
                                  const float* __restrict__ fields,
                                  int* __restrict__ counts,
                                  int* __restrict__ colmax, int S_cap, int W,
                                  int R, int NB, int T, int dedup) {
  constexpr int F = BOX ? 6 : 4;
  extern __shared__ float a_s[];  // [F][G]
  __shared__ int red[64];
  const int G = blockDim.x;
  const int slot = blockIdx.x;
  const int s = slot / W;
  const int j = threadIdx.x;
  const int SW = S_cap * W;
  const int TPW = 32 / NB, NW = R / TPW;
  int* cnt_o = counts + (size_t)slot * R;
  int* cmx_o = colmax + (size_t)slot * R;

  int any = 0;
  if (s < min(nsteps[0], S_cap)) {
    for (int q = 0; q < NW; ++q) any |= bm[(size_t)q * SW + slot];
  }
  if (any == 0) {
    for (int t = j; t < R; t += G) {
      cnt_o[t] = 0;
      cmx_o[t] = 0;
    }
    return;
  }
  const int ti = a_idx[s];
  const int base = run_idx[slot] & 0xFFFF;
#pragma unroll
  for (int f = 0; f < F; ++f) a_s[f * G + j] = fields[((size_t)f * T + ti) * G + j];
  __syncthreads();

  const int BH = G / NB;
  for (int t = 0; t < R; ++t) {
    const int word = bm[(size_t)(t / TPW) * SW + slot];
    const int bmt = (word >> (NB * (t % TPW))) & ((1 << NB) - 1);
    const int tj = base * R + t;
    if (bmt == 0 || tj >= T) {  // uniform over the block
      if (j == 0) {
        cnt_o[t] = 0;
        cmx_o[t] = 0;
      }
      continue;
    }
    float b[F];
#pragma unroll
    for (int f = 0; f < F; ++f) b[f] = fields[((size_t)f * T + tj) * G + j];
    const bool diag = dedup && tj == ti;
    int c = 0;
    for (int r = 0; r < NB; ++r) {
      if (!((bmt >> r) & 1)) continue;
      const int i1 = diag ? min((r + 1) * BH, j) : (r + 1) * BH;
      for (int i = r * BH; i < i1; ++i) c += ibvh::leaf_hit<BOX>(a_s, G, i, b);
    }
    int sum = 0, mx = 0;
    ibvh::block_sum_max(c, &sum, &mx, red);
    if (j == 0) {
      cnt_o[t] = sum;
      cmx_o[t] = mx;
    }
  }
}

}  // namespace

// a_idx: (S_cap,) i32; run_idx: (S_cap*W,) i32; bm: (R*NB/32, S_cap*W) i32
// band words; nsteps: (1,) i32; fields: (4 or 6, T, G) f32; counts, colmax:
// (S_cap*W*R,) i32.  G is the block size (a multiple of 32, at most 1024).
// Returns cudaGetLastError().
extern "C" int run_counts_launch(const void* a_idx, const void* run_idx,
                                 const void* bm, const void* nsteps,
                                 const void* fields, void* counts,
                                 void* colmax, int S_cap, int W, int R,
                                 int NB, int T, int G, int box, int dedup,
                                 void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024 || NB < 1 || 32 % NB != 0 ||
      R % (32 / NB) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = S_cap * W;
  const size_t shmem = (size_t)(box ? 6 : 4) * G * sizeof(float);
  if (blocks > 0) {
    auto kern = box ? run_counts_kernel<true> : run_counts_kernel<false>;
    kern<<<blocks, G, shmem, (cudaStream_t)stream>>>(
        (const int*)a_idx, (const int*)run_idx, (const int*)bm,
        (const int*)nsteps, (const float*)fields, (int*)counts, (int*)colmax,
        S_cap, W, R, NB, T, dedup);
  }
  return (int)cudaGetLastError();
}
