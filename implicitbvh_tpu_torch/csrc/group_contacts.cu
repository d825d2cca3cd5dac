// Padded per-pair contact slots: the grouped kernel and the packed-pair one.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_group_contacts
// (_group_kernel, _pair_compact_vrows) through group_contacts_launch, and
// tile_pair_contacts (_pair_kernel) through pair_contacts_launch, on all four
// masks (sphere, box, ray_box, ray_sphere) with one or two field sets: ti
// indexes the a set (Ta tiles), tj the b set (Tb tiles).  Entry e is one
// (a-tile ti, b-tile tj) pair with a 4-bit mask of the a-tile's live
// bands: in the grouped form ti = a_idx[e / W] and b_idx[e] packs
// tj | band << 16 (steps past nsteps, read on the device, are dead); in the
// packed form packed[e] = ti << 16 | tj, every band is live and entries past
// npairs are dead.  Under dedup (one field set) only tj*G + j > ti*G + i
// counts.
//
// One block per entry, one thread per a-row i: the b-tile's fields sit in
// shared memory and row i's in registers, prepared once (a ray's reciprocals
// or d.d).  Pass 1 tests row i against the
// b-tile (dead bands cost a branch) and counts it; a block scan gives the
// exclusive row offsets and the pair's uncapped count, which is written
// with the overflow flag (count > CAP_PAIR, or a row over ROW_CAP).  Pass 2
// runs only for pairs with contacts: row i re-tests and writes its first
// ROW_CAP contacts, in b-lane order, at lanes row_off[i] + s < CAP_PAIR as
// global sorted positions, and -1 in the lanes of its contacts past ROW_CAP,
// so every lane below min(count, CAP_PAIR) is defined.  Lanes past the
// count are never written or read, so the wrapper leaves the slots
// unfilled.  This replaces the TPU kernel's one-hot row and slot
// contractions.
//
// Bound on the H100: operations, num_checks leaf tests of ~11 flops
// (sphere), 6 comparisons (box) or some 30 operations (rays) against a few
// MB of reads and the few written slots.  Most pairs have no contacts and
// cost one pass.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BANDS = 4;

template <int KIND, bool PACKED>
__global__ void slot_contacts_kernel(const int* __restrict__ a_idx,
                                     const int* __restrict__ b_idx,
                                     const int* __restrict__ nlive,
                                     const float* __restrict__ a_fields,
                                     const float* __restrict__ b_fields,
                                     int* __restrict__ gi,
                                     int* __restrict__ gj,
                                     int* __restrict__ counts,
                                     int* __restrict__ over, int n_entries,
                                     int W, int Ta, int Tb, int dedup,
                                     int row_cap, int cap_pair) {
  constexpr int AP = ibvh::Mask<KIND>::AP;
  constexpr int FB = ibvh::Mask<KIND>::FB;
  extern __shared__ float b_s[];  // [FB][G]
  __shared__ int scan_sh[32];
  const int G = blockDim.x;
  const int e = blockIdx.x;
  const int i = threadIdx.x;

  int ti, tj, band;
  bool live;
  if constexpr (PACKED) {
    const int pk = a_idx[e];
    ti = (pk >> 16) & 0xFFFF;  // mask after the arithmetic shift
    tj = pk & 0xFFFF;
    band = (1 << BANDS) - 1;
    live = e < min(nlive[0], n_entries);
  } else {
    const int s = e / W;
    live = s < min(nlive[0], n_entries / W);
    ti = live ? a_idx[s] : 0;
    const int bw = b_idx[e];
    tj = bw & 0xFFFF;
    band = (bw >> 16) & ((1 << BANDS) - 1);
  }
  live = live && band != 0 && ti < Ta && tj < Tb && !(dedup && ti > tj);
  if (!live) {  // uniform over the block
    if (i == 0) counts[e] = 0;
    return;
  }

  float a[AP];
  ibvh::load_a_row<KIND>(a_fields, Ta, G, ti, i, a);
  {
    float b[FB];
    ibvh::load_b_leaf<KIND>(b_fields, Tb, G, tj, i, b);
#pragma unroll
    for (int f = 0; f < FB; ++f) b_s[f * G + i] = b[f];
  }
  __syncthreads();

  const bool row_live = (band >> (i / (G / BANDS))) & 1;
  const int j0 = (dedup && ti == tj) ? i + 1 : 0;
  int c = 0;
  if (row_live) {
    for (int j = j0; j < G; ++j) c += ibvh::row_hit<KIND>(a, b_s, G, j);
  }
  const int row_off = ibvh::block_exclusive_scan(c, scan_sh);
  const int total = scan_sh[(G >> 5) - 1];
  const int row_over = __syncthreads_or(c > row_cap);
  if (i == 0) {
    counts[e] = total;
    if (total > cap_pair || row_over) atomicOr(over, 1);
  }
  if (c == 0) return;

  const int lim = min(c, row_cap);
  int* gi_e = gi + (size_t)e * cap_pair;
  int* gj_e = gj + (size_t)e * cap_pair;
  int k = 0;
  for (int j = j0; j < G && k < lim && row_off + k < cap_pair; ++j) {
    if (ibvh::row_hit<KIND>(a, b_s, G, j)) {
      gi_e[row_off + k] = ti * G + i;
      gj_e[row_off + k] = tj * G + j;
      ++k;
    }
  }
  // a row over ROW_CAP leaves a gap in its lanes: fill it with -1
  for (int s = row_off + lim; s < min(row_off + c, cap_pair); ++s) {
    gi_e[s] = -1;
    gj_e[s] = -1;
  }
}

int launch(bool packed, const void* a_idx, const void* b_idx,
           const void* nlive, const void* a_fields, const void* b_fields,
           void* gi, void* gj, void* counts, void* over, int n_entries,
           int W, int Ta, int Tb, int G, int kind, int dedup, int row_cap,
           int cap_pair, void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024 || W < 1 || n_entries % W != 0 ||
      row_cap < 1 || cap_pair < 1)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)ibvh::b_fields_of(kind) * G * sizeof(float);
  if (n_entries > 0) {
    IBVH_DISPATCH_KIND(kind, {
      auto kern = packed ? slot_contacts_kernel<KIND, true>
                         : slot_contacts_kernel<KIND, false>;
      kern<<<n_entries, G, shmem, (cudaStream_t)stream>>>(
          (const int*)a_idx, (const int*)b_idx, (const int*)nlive,
          (const float*)a_fields, (const float*)b_fields, (int*)gi, (int*)gj,
          (int*)counts, (int*)over, n_entries, W, Ta, Tb, dedup, row_cap,
          cap_pair);
    })
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a_idx: (S_cap,) i32; b_idx: (S_cap*W,) i32; nsteps: (1,) i32; a_fields:
// (FA, Ta, G) f32; b_fields: (FB, Tb, G) f32 (may be a_fields); gi, gj:
// (S_cap*W, cap_pair) i32; counts: (S_cap*W,) i32; over: (1,) i32, zeroed by
// the caller.  kind: 0 sphere, 1 box, 2 ray_box, 3 ray_sphere.  G is the
// block size (a multiple of 32, at most 1024).  Returns cudaGetLastError().
extern "C" int group_contacts_launch(const void* a_idx, const void* b_idx,
                                     const void* nsteps, const void* a_fields,
                                     const void* b_fields, void* gi, void* gj,
                                     void* counts, void* over, int S_cap,
                                     int W, int Ta, int Tb, int G, int kind,
                                     int dedup, int row_cap, int cap_pair,
                                     void* stream) {
  return launch(false, a_idx, b_idx, nsteps, a_fields, b_fields, gi, gj,
                counts, over, S_cap * W, W, Ta, Tb, G, kind, dedup, row_cap,
                cap_pair, stream);
}

// packed: (P_cap,) i32 ti << 16 | tj; npairs: (1,) i32; the rest as above
// with P_cap entries.
extern "C" int pair_contacts_launch(const void* packed, const void* npairs,
                                    const void* a_fields,
                                    const void* b_fields, void* gi, void* gj,
                                    void* counts, void* over, int P_cap,
                                    int Ta, int Tb, int G, int kind,
                                    int dedup, int row_cap, int cap_pair,
                                    void* stream) {
  return launch(true, packed, packed, npairs, a_fields, b_fields, gi, gj,
                counts, over, P_cap, 1, Ta, Tb, G, kind, dedup, row_cap,
                cap_pair, stream);
}
