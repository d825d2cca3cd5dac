// Dense contact stream of the pre-counted tile pairs.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_group_emit
// (_group_emit_kernel, _pair_compact_vrows, _stream_flush) on all four masks
// (sphere, box, ray_box, ray_sphere), with one or two field sets.  Entry e of
// the emit list packs tj | band << 16 | cnt << 20 | okc << 28; its output
// offset offs[e] is the exclusive prefix sum of min(cnt, CAP_PAIR) over the
// entries (computed by the caller), which replaces the TPU's SMEM cursor and
// aligned flushes.  Block e takes a-tile a_idx[e / W] of the a set against
// b-tile tj of the b set, one thread per b-column j: the thread counts its
// column's contacts over the 4 coarse bands the entry marks live, a block
// scan turns the counts into
// offsets, and the thread writes each contact's global sorted positions
// (ti*G+i, tj*G+j) as int32, column-major within the pair.  Writes stop at
// min(cnt, CAP_PAIR) within the pair and at `cap` overall.  Pairs with
// cnt >= 2 and okc == 0 count their rows in shared memory; a row holding
// more than ROW_CAP contacts sets *row_over, as the TPU kernel's one-hot
// compaction flags it (with a ray mask a row is a ray).  ti and tj are
// compared only under `dedup` (one field set).
//
// Bound on the H100: operations on the live pairs' leaf tests (two passes of
// the mask) against a few MB of traffic; the a-tile is in shared memory,
// prepared once per block (ray reciprocals, d.d), and each b-leaf in
// registers.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int EMIT_BANDS = 4;

template <int KIND>
__global__ void group_emit_kernel(const int* __restrict__ a_idx,
                                  const int* __restrict__ b_idx,
                                  const int* __restrict__ nsteps,
                                  const int* __restrict__ offs,
                                  const float* __restrict__ a_fields,
                                  const float* __restrict__ b_fields,
                                  int* __restrict__ gi, int* __restrict__ gj,
                                  int* __restrict__ row_over, int S_cap,
                                  int W, int Ta, int Tb, int dedup,
                                  int row_cap, int cap_pair, int cap) {
  constexpr int AP = ibvh::Mask<KIND>::AP;
  constexpr int FB = ibvh::Mask<KIND>::FB;
  extern __shared__ float a_s[];  // [AP][G] prepared rows, then G row counts
  __shared__ int scan_sh[32];
  const int G = blockDim.x;
  const int e = blockIdx.x;
  const int s = e / W;
  if (s >= min(nsteps[0], S_cap)) return;
  const int bw = b_idx[e];
  const int cnt = (bw >> 20) & 0xFF;
  if (cnt == 0) return;
  const int tj = bw & 0xFFFF;
  const int bm = (bw >> 16) & ((1 << EMIT_BANDS) - 1);
  const bool slow = cnt >= 2 && ((bw >> 28) & 1) == 0;
  const int ti = a_idx[s];
  const int lim = min(cnt, cap_pair);
  const int j = threadIdx.x;
  int* rowcnt = reinterpret_cast<int*>(a_s + AP * G);

  {
    float a[AP];
    ibvh::load_a_row<KIND>(a_fields, Ta, G, ti, j, a);
#pragma unroll
    for (int f = 0; f < AP; ++f) a_s[f * G + j] = a[f];
  }
  rowcnt[j] = 0;
  __syncthreads();

  const bool live = tj < Tb;
  float b[FB];
  if (live) ibvh::load_b_leaf<KIND>(b_fields, Tb, G, tj, j, b);
  const int BH = G / EMIT_BANDS;
  const bool diag = dedup && tj == ti;
  int c = 0;
  if (live) {
    for (int r = 0; r < EMIT_BANDS; ++r) {
      if (!((bm >> r) & 1)) continue;
      const int i1 = diag ? min((r + 1) * BH, j) : (r + 1) * BH;
      for (int i = r * BH; i < i1; ++i) {
        if (ibvh::leaf_hit<KIND>(a_s, G, i, b)) {
          ++c;
          if (slow) atomicAdd(&rowcnt[i], 1);
        }
      }
    }
  }
  int k = ibvh::block_exclusive_scan(c, scan_sh);
  if (live && k < lim) {
    const int base = offs[e];
    for (int r = 0; r < EMIT_BANDS && k < lim; ++r) {
      if (!((bm >> r) & 1)) continue;
      const int i1 = diag ? min((r + 1) * BH, j) : (r + 1) * BH;
      for (int i = r * BH; i < i1 && k < lim; ++i) {
        if (ibvh::leaf_hit<KIND>(a_s, G, i, b)) {
          const int o = base + k;
          if (o < cap) {
            gi[o] = ti * G + i;
            gj[o] = tj * G + j;
          }
          ++k;
        }
      }
    }
  }
  if (slow) {  // uniform over the block
    __syncthreads();
    if (rowcnt[j] > row_cap) atomicOr(row_over, 1);
  }
}

}  // namespace

// a_idx: (S_cap,) i32; b_idx, offs: (S_cap*W,) i32; nsteps: (1,) i32;
// a_fields: (FA, Ta, G) f32; b_fields: (FB, Tb, G) f32 (may be a_fields);
// gi, gj: (cap,) i32; row_over: (1,) i32.  kind: 0 sphere, 1 box, 2 ray_box,
// 3 ray_sphere.  G is the block size (a multiple of 4 and of 32, at most
// 1024).  Returns cudaGetLastError().
extern "C" int group_emit_launch(const void* a_idx, const void* b_idx,
                                 const void* nsteps, const void* offs,
                                 const void* a_fields, const void* b_fields,
                                 void* gi, void* gj, void* row_over,
                                 int S_cap, int W, int Ta, int Tb, int G,
                                 int kind, int dedup, int row_cap,
                                 int cap_pair, int cap, void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024) return (int)cudaErrorInvalidValue;
  const int blocks = S_cap * W;
  const size_t shmem =
      ((size_t)ibvh::prepared_a_floats(kind) * G + G) * sizeof(float);
  if (blocks > 0) {
    IBVH_DISPATCH_KIND(kind, {
      group_emit_kernel<KIND><<<blocks, G, shmem, (cudaStream_t)stream>>>(
          (const int*)a_idx, (const int*)b_idx, (const int*)nsteps,
          (const int*)offs, (const float*)a_fields, (const float*)b_fields,
          (int*)gi, (int*)gj, (int*)row_over, S_cap, W, Ta, Tb, dedup,
          row_cap, cap_pair, cap);
    })
  }
  return (int)cudaGetLastError();
}
