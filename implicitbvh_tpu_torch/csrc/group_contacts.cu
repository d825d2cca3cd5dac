// Padded per-pair contact slots: the grouped kernel and the packed-pair one.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_group_contacts
// (_group_kernel, _pair_compact_vrows) through group_contacts_launch, and
// tile_pair_contacts (_pair_kernel) through pair_contacts_launch, on all four
// masks (sphere, box, ray_box, ray_sphere) with one or two field sets, in
// float or double (the fields' type; both sets of one type): ti indexes the
// a set (Ta tiles), tj the b set (Tb tiles).  Entry e is one
// (a-tile ti, b-tile tj) pair with a 4-bit mask of the a-tile's live
// bands: in the grouped form ti = a_idx[e / W] and b_idx[e] packs
// tj | band << 16 (steps past nsteps, read on the device, are dead); in the
// packed form packed[e] = ti << 16 | tj, every band is live and entries past
// npairs are dead (a step of one entry).  Under dedup (one field set) only
// tj*G + j > ti*G + i counts.
//
// Bound on the H100: the instruction rate, as the count kernel
// (run_counts.cu): num_checks explicitly rounded leaf tests against a few MB
// of reads and the few written slots.  The design:
//
// - A persistent grid works through the live entries (of the steps below
//   nsteps, read on the device: no host sync).  Its teams of G/k threads (a
//   warp at tiles of 32 to 128, four to a block; the whole block above)
//   take groups of up to 32 entries in turn from a counter (as the count
//   kernel does), look up a group's
//   entries at once, one per lane, and take the live ones in turn; dead
//   entries cost a lane, dead steps no block (the grid zeroes their counts
//   with 16-byte stores).  Each thread owns k a-rows i = p + m*G/k (k =
//   4, 2 or 1).  The team prepares its a-tile once (a ray's reciprocals or
//   4 d.d) as records of four values (16 bytes, 32 in double) in shared
//   memory and keeps it while the
//   entries share it, as the W entries of a step do; each entry's b-tile
//   goes through shared memory as records too.  Per entry a thread loads
//   only its rows of live bands into registers, so one broadcast 128-bit
//   load of a b-leaf (two for boxes) feeds them all.  At tile 128 a
//   thread's k = 4 rows lie in 4 bands, one each, the same for every lane,
//   so band skipping never splits the warp: there pass 1 is compiled once
//   for each count of live rows and the rows of dead bands cost nothing.
//   (Compiled once for each set of live rows, 15 at k = 4, it missed the
//   instruction cache: 8.09 ms in place of 3.31 at the full-width ray
//   scene on an H100.)  At other tiles, where liveness would split a warp
//   or a team is the block, one copy tests all k rows and counts the live.
//   Both tiles' records take more than 48 KB of shared memory at tiles
//   above 768 (box masks) and at 1024 (ray_sphere) in float, and in double
//   from tile 128 (four warp teams of box records, 64 KB) up to 128 KB at
//   tile 1024 (box): persistent_blocks opts the kernel in to more, so every
//   tile launches in both types, double with fewer blocks an SM.
// - Pass 1 counts each row; one team scan in row order gives the
//   exclusive row offsets and the pair's uncapped count, written with the
//   overflow flag (count > CAP_PAIR, or a row over ROW_CAP).  Pass 2 runs
//   only for pairs with contacts: each row with contacts re-tests and writes
//   its first ROW_CAP contacts, in b-lane order, at lanes row_off[i] + s <
//   CAP_PAIR as global sorted positions, and -1 in the lanes of its
//   contacts past ROW_CAP, so every lane below min(count, CAP_PAIR) is
//   defined.  Lanes past the count are never written or read, so the
//   wrapper leaves the slots unfilled.  This replaces the TPU kernel's
//   one-hot row and slot contractions.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BANDS = 4;

// Pass 1 over b-leaves [j0, G) of the records for the first NL of the
// thread's rows of live bands, a[q] (rows i[q]), counting those below nl;
// DIAG keeps j > i only.
template <typename T, int KIND, int K, int NL, bool DIAG>
__device__ __forceinline__ void count_cols(
    const ibvh::rec_t<T>* b_s, int j0, int G,
    const T (&a)[K][4 * ibvh::Rec<KIND>::RA], const int (&i)[K], int nl,
    int (&c)[K]) {
  constexpr int RB = ibvh::Rec<KIND>::RB;
  // unrolled twice only: at warp teams of k = 4 the K copies of this loop
  // (one per count of live rows) run side by side and share the
  // instruction cache
#pragma unroll 2
  for (int j = j0; j < G; ++j) {
    T b[4 * RB];
    ibvh::load_rec<RB>(b_s, j, b);
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      bool h = ibvh::rec_hit<KIND>(a[q], b);
      if constexpr (DIAG) h = h && j > i[q];
      c[q] += h && q < nl;
    }
  }
}

// Pass 1 for the run-time count nl (0 to K) of live rows.  Where that count
// is the same for every thread of a warp (warp teams at k = 4: row m lies
// in band m), one copy per count skips the rows of dead bands; elsewhere
// one copy tests all K rows and counts the live ones.
template <typename T, int KIND, int K, bool WARP, bool DIAG, int NL = 1>
__device__ __forceinline__ void count_live(
    int nl, const ibvh::rec_t<T>* b_s, int j0, int G,
    const T (&a)[K][4 * ibvh::Rec<KIND>::RA], const int (&i)[K],
    int (&c)[K]) {
  if constexpr (!(WARP && K == 4)) {
    count_cols<T, KIND, K, K, DIAG>(b_s, j0, G, a, i, nl, c);
  } else if constexpr (NL <= K) {
    if (nl == NL)
      count_cols<T, KIND, K, NL, DIAG>(b_s, j0, G, a, i, NL, c);
    else
      count_live<T, KIND, K, WARP, DIAG, NL + 1>(nl, b_s, j0, G, a, i, c);
  }
}

template <typename T, int KIND, int K, bool PACKED, bool WARP>
__global__ void slot_contacts_kernel(const int* __restrict__ a_idx,
                                     const int* __restrict__ b_idx,
                                     const int* __restrict__ nlive,
                                     const T* __restrict__ a_fields,
                                     const T* __restrict__ b_fields,
                                     int* __restrict__ gi,
                                     int* __restrict__ gj,
                                     int* __restrict__ counts,
                                     int* __restrict__ over, int n_steps,
                                     int W, int Ta, int Tb, int dedup,
                                     int row_cap, int cap_pair) {
  constexpr int RA = ibvh::Rec<KIND>::RA, RB = ibvh::Rec<KIND>::RB;
  constexpr int AR = 4 * RA;
  constexpr unsigned FULL = 0xffffffffu;
  const ibvh::Team<WARP> team;
  const int N = WARP ? 32 : blockDim.x, G = N * K, p = team.rank();
  const int lane = threadIdx.x & 31;
  const bool writer = WARP || threadIdx.x < 32;  // writes a group's counts
  const int BH = G / BANDS;
  extern __shared__ float4 smem[];
  ibvh::rec_t<T>* a_s = reinterpret_cast<ibvh::rec_t<T>*>(smem) +
                        (size_t)team.index() * G * (RA + RB);  // [G][RA]
  ibvh::rec_t<T>* b_s = a_s + (size_t)G * RA;                  // [G][RB]
  __shared__ int scan_sh[32];  // a larger team's scan
  __shared__ int grab_sh;
  const int live_steps = min(nlive[0], n_steps);
  const long long L = (long long)live_steps * W;  // live entries

  int ir[K];  // the thread's rows
#pragma unroll
  for (int m = 0; m < K; ++m) ir[m] = p + m * N;
  int loaded = -1;  // the a-tile held in a_s

  const int gs = team.group_size(L);
  for (;;) {
    const long long g0 = (long long)gs * team.grab(over + 1, &grab_sh);
    if (g0 >= L) break;
    // lane l looks up entry g0 + l; the team then takes the live ones
    const long long e = g0 + lane;
    const bool valid = lane < gs && e < L;
    int ti = Ta, tj = Tb, band = 0;
    if (valid) {
      if constexpr (PACKED) {
        const int pk = a_idx[e];
        ti = (pk >> 16) & 0xFFFF;  // mask after the arithmetic shift
        tj = pk & 0xFFFF;
        band = (1 << BANDS) - 1;
      } else {
        ti = a_idx[e / W];
        const int bw = b_idx[e];
        tj = bw & 0xFFFF;
        band = (bw >> 16) & ((1 << BANDS) - 1);
      }
    }
    unsigned todo = __ballot_sync(FULL, band != 0 && ti < Ta && tj < Tb &&
                                            !(dedup && ti > tj));
    int my_count = 0;
    while (todo) {  // uniform over the team
      const int q = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long e_q = g0 + q;
      const int ti_q = __shfl_sync(FULL, ti, q);
      const int tj_q = __shfl_sync(FULL, tj, q);
      const int band_q = __shfl_sync(FULL, band, q);
      if (ti_q != loaded) {
        team.sync();  // the previous entries' readers are done with a_s
#pragma unroll
        for (int m = 0; m < K; ++m) {
          T a[4 * RA];
          ibvh::load_a_rec<KIND>(a_fields, Ta, G, ti_q, ir[m], a);
          ibvh::store_rec<RA>(a_s, ir[m], a);
        }
        loaded = ti_q;
      }
      team.sync();  // the previous entry's readers are done with b_s
#pragma unroll
      for (int m = 0; m < K; ++m) {
        T b[4 * RB];
        ibvh::load_b_rec<KIND>(b_fields, Tb, G, tj_q, ir[m], b);
        ibvh::store_rec<RB>(b_s, ir[m], b);
      }
      team.sync();

      // the thread's rows of live bands, in order, into registers: row
      // ic[q] = ir[mc[q]] for q < nl
      const bool diag = dedup && ti_q == tj_q;
      int bits = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) bits |= ((band_q >> (ir[m] / BH)) & 1) << m;
      const int nl = __popc(bits);
      T ac[K][AR];
      int ic[K], mc[K], cq[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        mc[q] = bits ? __ffs(bits) - 1 : 0;
        bits &= bits - 1;
        ic[q] = p + mc[q] * N;
        ibvh::load_rec<RA>(a_s, ic[q], ac[q]);
        cq[q] = 0;
      }
      if (diag)
        count_live<T, KIND, K, WARP, true>(nl, b_s, ic[0] + 1, G, ac, ic,
                                           cq);
      else
        count_live<T, KIND, K, WARP, false>(nl, b_s, 0, G, ac, ic, cq);
      int c[K];  // per row, in row order
#pragma unroll
      for (int m = 0; m < K; ++m) {
        c[m] = 0;
#pragma unroll
        for (int q = 0; q < K; ++q)
          if (q < nl && mc[q] == m) c[m] = cq[q];
      }

      int row_off[K], big = 0, total, row_over;
#pragma unroll
      for (int m = 0; m < K; ++m) big |= c[m] > row_cap;
      if constexpr (WARP) {
        total = ibvh::warp_exclusive_scan_k<K>(c, row_off);
        row_over = __any_sync(FULL, big);
      } else {
        total = ibvh::block_exclusive_scan_k<K>(c, row_off, scan_sh);
        row_over = __syncthreads_or(big);
      }
      if (lane == q) my_count = total;
      if (p == 0 && (total > cap_pair || row_over)) atomicOr(over, 1);
      if (total == 0) continue;  // uniform over the team

      int* gi_e = gi + (size_t)e_q * cap_pair;
      int* gj_e = gj + (size_t)e_q * cap_pair;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (c[m] == 0) continue;
        const int i = ir[m], off = row_off[m];
        const int lim = min(c[m], row_cap);
        T a[4 * RA];
        ibvh::load_rec<RA>(a_s, i, a);
        int k = 0;
#pragma unroll 1
        for (int j = diag ? i + 1 : 0; j < G && k < lim && off + k < cap_pair;
             ++j) {
          T b[4 * RB];
          ibvh::load_rec<RB>(b_s, j, b);
          if (ibvh::rec_hit<KIND>(a, b)) {
            gi_e[off + k] = ti_q * G + i;
            gj_e[off + k] = tj_q * G + j;
            ++k;
          }
        }
        // a row over ROW_CAP leaves a gap in its lanes: fill it with -1
        for (int s = off + lim; s < min(off + c[m], cap_pair); ++s) {
          gi_e[s] = -1;
          gj_e[s] = -1;
        }
      }
    }
    if (valid && writer) counts[e] = my_count;  // dead entries: 0
  }
  // the entries of dead steps
  ibvh::grid_zero(counts, (long long)live_steps * W, (long long)n_steps * W);
}

template <typename T, int KIND, int K, bool WARP>
void launch_kind(bool packed, const void* a_idx, const void* b_idx,
                 const void* nlive, const void* a_fields,
                 const void* b_fields, void* gi, void* gj, void* counts,
                 void* over, int n_steps, int W, int Ta, int Tb, int G,
                 int dedup, int row_cap, int cap_pair, cudaStream_t stream) {
  auto kern = packed ? slot_contacts_kernel<T, KIND, K, true, WARP>
                     : slot_contacts_kernel<T, KIND, K, false, WARP>;
  // teams of one warp go WARP_TEAMS to a block; a larger team is the block
  const int threads = WARP ? 32 * ibvh::WARP_TEAMS : G / K;
  const int teams = threads / (G / K);
  const size_t shmem = (size_t)teams * G *
                       (ibvh::Rec<KIND>::RA + ibvh::Rec<KIND>::RB) *
                       sizeof(ibvh::rec_t<T>);
  const long long entries = (long long)n_steps * W;
  const int blocks = ibvh::persistent_blocks(kern, threads, shmem,
                                             (entries + teams - 1) / teams);
  kern<<<blocks, threads, shmem, stream>>>(
      (const int*)a_idx, (const int*)b_idx, (const int*)nlive,
      (const T*)a_fields, (const T*)b_fields, (int*)gi, (int*)gj,
      (int*)counts, (int*)over, n_steps, W, Ta, Tb, dedup, row_cap,
      cap_pair);
}

int launch(bool packed, const void* a_idx, const void* b_idx,
           const void* nlive, const void* a_fields, const void* b_fields,
           void* gi, void* gj, void* counts, void* over, int n_entries,
           int W, int Ta, int Tb, int G, int kind, int dedup, int row_cap,
           int cap_pair, int value_bits, void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024 || W < 1 || n_entries % W != 0 ||
      row_cap < 1 || cap_pair < 1 || ((size_t)counts & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_steps = n_entries / W;
  if (n_steps > 0) {
    IBVH_DISPATCH_VALUE(
        value_bits,
        IBVH_DISPATCH_KIND(kind, IBVH_DISPATCH_TEAM(
            G, launch_kind, packed, a_idx, b_idx, nlive, a_fields, b_fields,
            gi, gj, counts, over, n_steps, W, Ta, Tb, G, dedup, row_cap,
            cap_pair, (cudaStream_t)stream)))
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a_idx: (S_cap,) i32; b_idx: (S_cap*W,) i32; nsteps: (1,) i32; a_fields:
// (FA, Ta, G); b_fields: (FB, Tb, G) (may be a_fields); both float
// (value_bits 32) or double (64); gi, gj:
// (S_cap*W, cap_pair) i32; counts: (S_cap*W,) i32, 16-byte aligned; over:
// (2,) i32, zeroed by the caller: the overflow flag, then the kernel's work
// counter.  kind: 0 sphere, 1 box, 2 ray_box, 3
// ray_sphere.  G is the tile size (a multiple of 32, at most 1024).
// Returns cudaGetLastError().
extern "C" int group_contacts_launch(const void* a_idx, const void* b_idx,
                                     const void* nsteps, const void* a_fields,
                                     const void* b_fields, void* gi, void* gj,
                                     void* counts, void* over, int S_cap,
                                     int W, int Ta, int Tb, int G, int kind,
                                     int dedup, int row_cap, int cap_pair,
                                     int value_bits, void* stream) {
  return launch(false, a_idx, b_idx, nsteps, a_fields, b_fields, gi, gj,
                counts, over, S_cap * W, W, Ta, Tb, G, kind, dedup, row_cap,
                cap_pair, value_bits, stream);
}

// packed: (P_cap,) i32 ti << 16 | tj; npairs: (1,) i32; the rest as above
// with P_cap entries.
extern "C" int pair_contacts_launch(const void* packed, const void* npairs,
                                    const void* a_fields,
                                    const void* b_fields, void* gi, void* gj,
                                    void* counts, void* over, int P_cap,
                                    int Ta, int Tb, int G, int kind,
                                    int dedup, int row_cap, int cap_pair,
                                    int value_bits, void* stream) {
  return launch(true, packed, packed, npairs, a_fields, b_fields, gi, gj,
                counts, over, P_cap, 1, Ta, Tb, G, kind, dedup, row_cap,
                cap_pair, value_bits, stream);
}
