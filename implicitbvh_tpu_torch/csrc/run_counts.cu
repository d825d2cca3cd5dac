// Exact contact counts of every (step, w, t) tile pair of the run list, and
// with `words` the per-column moment words of the decode route.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_run_counts
// (_run_count_kernel, _acols, _band_mask) on all four masks (sphere, box,
// ray_box, ray_sphere), with one or two field sets and with moments.
// Block (s, w) takes a-tile a_idx[s] of the a set against the R b-tiles of
// the aligned run run_idx[s*W+w] of the b set; one thread per b-column j.
// For each tile t whose NB band bits are not all zero, the thread loops over
// the a-rows of the live bands only (the dead bands are skipped exactly as
// the bits say: band skipping is part of the result) and counts its
// column's contacts, with the j > i dedup on the diagonal pair when `dedup`
// is set (never otherwise: with two field sets ti and tj index different
// sets and are not compared).  A block reduction writes the pair's count and
// its largest column count (colmax) straight to the reduced (S_cap*W*R,)
// outputs: no per-lane count plane is materialised.  Slots with
// s >= min(nsteps, S_cap) (read on the device) write zeros.
//
// Moments: the thread already holds every hit of its column, so it also
// sums the hit rows i and their squares and writes the column's word
// cc << 23 | (cc <= 2 ? (sum i << 15) + sum i^2 : 0) into row (slot*R + t)
// of the (S_cap*W*R, 128) word plane (lanes >= G zero).  With cc <= 2 the
// sum never carries between its fields; with cc > 2 the field is zero by
// definition.  The kernel writes the whole plane, zero rows for dead tiles
// and dead blocks included, so the wrapper allocates it uninitialised.
//
// Bound on the H100: operations without moments (num_checks leaf tests of
// ~11 flops for spheres, more for rays, against a few hundred MB of traffic
// at most); with moments the word plane's bytes can take over (1.6 GB at
// 100k rays against 262k leaves).  The a-tile sits in shared memory, prepared
// once per block (ray reciprocals, d.d), each b-leaf in registers, and dead
// tiles and bands cost only a branch.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WORD_LANES = 128;

template <int KIND, bool MOMENTS>
__global__ void run_counts_kernel(const int* __restrict__ a_idx,
                                  const int* __restrict__ run_idx,
                                  const int* __restrict__ bm,
                                  const int* __restrict__ nsteps,
                                  const float* __restrict__ a_fields,
                                  const float* __restrict__ b_fields,
                                  int* __restrict__ counts,
                                  int* __restrict__ colmax,
                                  int* __restrict__ words, int S_cap, int W,
                                  int R, int NB, int Ta, int Tb, int dedup) {
  constexpr int AP = ibvh::Mask<KIND>::AP;
  constexpr int FB = ibvh::Mask<KIND>::FB;
  extern __shared__ float a_s[];  // [AP][G]
  __shared__ int red[64];
  const int G = blockDim.x;
  const int slot = blockIdx.x;
  const int s = slot / W;
  const int j = threadIdx.x;
  const int SW = S_cap * W;
  const int TPW = 32 / NB, NW = R / TPW;
  int* cnt_o = counts + (size_t)slot * R;
  int* cmx_o = colmax + (size_t)slot * R;
  int* wrd_o = MOMENTS ? words + (size_t)slot * R * WORD_LANES : nullptr;

  int any = 0;
  if (s < min(nsteps[0], S_cap)) {
    for (int q = 0; q < NW; ++q) any |= bm[(size_t)q * SW + slot];
  }
  if (any == 0) {
    for (int t = j; t < R; t += G) {
      cnt_o[t] = 0;
      cmx_o[t] = 0;
    }
    if constexpr (MOMENTS) {
      for (int k = j; k < R * WORD_LANES; k += G) wrd_o[k] = 0;
    }
    return;
  }
  const int ti = a_idx[s];
  const int base = run_idx[slot] & 0xFFFF;
  {
    float a[AP];
    ibvh::load_a_row<KIND>(a_fields, Ta, G, ti, j, a);
#pragma unroll
    for (int f = 0; f < AP; ++f) a_s[f * G + j] = a[f];
  }
  __syncthreads();

  const int BH = G / NB;
  for (int t = 0; t < R; ++t) {
    const int word = bm[(size_t)(t / TPW) * SW + slot];
    const int bmt = (word >> (NB * (t % TPW))) & ((1 << NB) - 1);
    const int tj = base * R + t;
    if (bmt == 0 || tj >= Tb) {  // uniform over the block
      if (j == 0) {
        cnt_o[t] = 0;
        cmx_o[t] = 0;
      }
      if constexpr (MOMENTS) {
        for (int k = j; k < WORD_LANES; k += G) wrd_o[t * WORD_LANES + k] = 0;
      }
      continue;
    }
    float b[FB];
    ibvh::load_b_leaf<KIND>(b_fields, Tb, G, tj, j, b);
    const bool diag = dedup && tj == ti;
    int c = 0, si = 0, sq = 0;
    for (int r = 0; r < NB; ++r) {
      if (!((bmt >> r) & 1)) continue;
      const int i1 = diag ? min((r + 1) * BH, j) : (r + 1) * BH;
      for (int i = r * BH; i < i1; ++i) {
        const int h = ibvh::leaf_hit<KIND>(a_s, G, i, b);
        c += h;
        if constexpr (MOMENTS) {
          si += h * i;
          sq += h * i * i;
        }
      }
    }
    if constexpr (MOMENTS) {
      if (j < WORD_LANES)
        wrd_o[t * WORD_LANES + j] = (c << 23) | (c <= 2 ? (si << 15) + sq : 0);
      for (int k = G + j; k < WORD_LANES; k += G)
        wrd_o[t * WORD_LANES + k] = 0;
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
// band words; nsteps: (1,) i32; a_fields: (FA, Ta, G) f32; b_fields:
// (FB, Tb, G) f32 (may be a_fields); counts, colmax: (S_cap*W*R,) i32;
// words: (S_cap*W*R, 128) i32 or null (no moments; with moments G <= 128).
// kind: 0 sphere, 1 box, 2 ray_box, 3 ray_sphere.  G is the block size (a
// multiple of 32, at most 1024).  Returns cudaGetLastError().
extern "C" int run_counts_launch(const void* a_idx, const void* run_idx,
                                 const void* bm, const void* nsteps,
                                 const void* a_fields, const void* b_fields,
                                 void* counts, void* colmax, void* words,
                                 int S_cap, int W, int R, int NB, int Ta,
                                 int Tb, int G, int kind, int dedup,
                                 void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024 || NB < 1 || 32 % NB != 0 ||
      R % (32 / NB) != 0 || (words != nullptr && G > WORD_LANES))
    return (int)cudaErrorInvalidValue;
  const int blocks = S_cap * W;
  const size_t shmem =
      (size_t)ibvh::prepared_a_floats(kind) * G * sizeof(float);
  if (blocks > 0) {
    IBVH_DISPATCH_KIND(kind, {
      auto kern = words ? run_counts_kernel<KIND, true>
                        : run_counts_kernel<KIND, false>;
      kern<<<blocks, G, shmem, (cudaStream_t)stream>>>(
          (const int*)a_idx, (const int*)run_idx, (const int*)bm,
          (const int*)nsteps, (const float*)a_fields, (const float*)b_fields,
          (int*)counts, (int*)colmax, (int*)words, S_cap, W, R, NB, Ta, Tb,
          dedup);
    })
  }
  return (int)cudaGetLastError();
}
