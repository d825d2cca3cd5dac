// Exact contact counts of every (step, w, t) tile pair of the run list, and
// with `words` the per-column moment words of the decode route.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_run_counts
// (_run_count_kernel, _acols, _band_mask) on all four masks (sphere, box,
// ray_box, ray_sphere), with one or two field sets and with moments, in
// float or double (the fields' type; both sets of one type).
//
// Bound on the H100: the instruction rate.  The predicates are explicitly
// rounded (no FMA), so every counted operation is one instruction, and the
// floor is num_checks tests x their float operations over the card's
// non-FMA fp32 rate (twice the operations bound that counts an FMA as two);
// the field reads are a few hundred MB of L2 traffic at most.  The design
// cuts the instructions issued per test and launches for live work only:
//
// - A persistent grid (as many blocks as fit on the card) works through
//   the live pairs slot*R + t of the steps s < min(nsteps, S_cap), read on
//   the device so that nothing syncs with the host.  Its teams of G/k
//   threads (a warp at tiles of 32 to 128, four to a block; the whole block
//   above) take groups of up to 32 pairs in turn from a counter, which
//   balances the grid as the hardware balanced a grid of one block per
//   slot (smaller groups where few pairs are live: a group of 32 left most
//   of the card idle at the 65,536-box scene's 27,520 pairs).  A team looks
//   up a group's pairs at once, one per lane, and tests the live
//   ones (a non-zero band nibble, tj < Tb) in turn, so a dead pair costs a
//   lane and a dead step no block: the grid zeroes the dead steps' counts
//   and colmax with 16-byte stores.  The team keeps its step's a-tile
//   a_idx[s], prepared once (ray reciprocals, 4 d.d), as 16-byte records in
//   shared memory until the step changes.  (One block per step, tried
//   first, left the card idle where few steps are live: one warp took a
//   step's W*R pairs in turn.)
// - Each of the G/k threads owns k b-columns j = p + m*G/k (k = 4, 2 or 1,
//   the largest that keeps the team a multiple of 32) in registers, so
//   one broadcast 128-bit load of an a-row (two for boxes and rays; twice
//   as many in double, whose records are 32 bytes) feeds k tests.  The thread loops over the rows of the live bands only (band
//   skipping is part of the result), each run of adjacent live bands as one
//   loop, with the j > i dedup per column on the diagonal pair when `dedup`
//   is set (never otherwise: with two field sets ti and tj index different
//   sets).  Moment sums are taken only under the hit predicate.
// - Each pair's count and largest column count (colmax) are reduced in
//   the team and written straight to the reduced (S_cap*W*R,) outputs, 32
//   pairs to a store: no per-lane count plane.
//
// Moments: the thread holds every hit of its columns, so it writes each
// column's word cc << 23 | (cc <= 2 ? (sum i << 15) + sum i^2 : 0) into row
// (slot*R + t) of the (S_cap*W*R, 128) plane, and zeroes lanes G..127.  With
// cc <= 2 the sum never carries between its fields; with cc > 2 the field
// is zero by definition.  Only the rows of live pairs (a live step, a
// non-zero band nibble, tj < Tb) are written; the moment decode reads no
// other row, so the rest of the plane (1.6 GB at 100k rays against 262k
// leaves, almost all of it dead) stays unwritten.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WORD_LANES = 128;

// Rows [i0, i1) of the a-tile records against the thread's K columns:
// counts c and, with moments, the sums sw of (i << 15) + i^2 over the hit
// rows i, which equal (sum i << 15) + sum i^2 for the at most 2 hits whose
// word keeps them (no carry between the fields; more hits may wrap).
template <typename T, int KIND, int K, bool MOMENTS, bool DIAG>
__device__ __forceinline__ void count_rows(
    const ibvh::rec_t<T>* a_s, int i0, int i1,
    const T (&b)[K][4 * ibvh::Rec<KIND>::RB], const int (&j)[K],
    int (&c)[K], int (&sw)[K]) {
  constexpr int RA = ibvh::Rec<KIND>::RA;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    T a[4 * RA];
    ibvh::load_rec<RA>(a_s, i, a);
    const int wi = (i << 15) + i * i;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      bool h = ibvh::rec_hit<KIND>(a, b[m]);
      if constexpr (DIAG) h = h && i < j[m];
      c[m] += h;
      if constexpr (MOMENTS) {
        if (h) sw[m] += wi;
      }
    }
  }
}

template <typename T, int KIND, int K, bool MOMENTS, bool WARP>
__global__ void run_counts_kernel(const int* __restrict__ a_idx,
                                  const int* __restrict__ run_idx,
                                  const int* __restrict__ bm,
                                  const int* __restrict__ nsteps,
                                  const T* __restrict__ a_fields,
                                  const T* __restrict__ b_fields,
                                  int* __restrict__ counts,
                                  int* __restrict__ colmax,
                                  int* __restrict__ words,
                                  int* __restrict__ work, int S_cap, int W,
                                  int R, int NB, int Ta, int Tb, int dedup) {
  constexpr int RA = ibvh::Rec<KIND>::RA, RB = ibvh::Rec<KIND>::RB;
  constexpr unsigned FULL = 0xffffffffu;
  const ibvh::Team<WARP> team;
  const int N = WARP ? 32 : blockDim.x, G = N * K, p = team.rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, NWP = N >> 5;
  const bool writer = WARP || warp == 0;  // writes a group's counts
  extern __shared__ float4 smem[];
  ibvh::rec_t<T>* recs = reinterpret_cast<ibvh::rec_t<T>*>(smem);
  ibvh::rec_t<T>* a_s = recs + (size_t)team.index() * G * RA;  // [G][RA]
  // a larger team's per-warp partial sums and maxima
  int* part = reinterpret_cast<int*>(recs + (size_t)(blockDim.x / N) * G * RA);
  const int SW = S_cap * W, TPW = 32 / NB, BH = G / NB;
  __shared__ int grab_sh;
  const int live_steps = min(nsteps[0], S_cap);
  const long long L = (long long)live_steps * W * R;  // pairs slot * R + t

  int jc[K];
#pragma unroll
  for (int m = 0; m < K; ++m) jc[m] = p + m * N;
  int loaded = -1, ti = 0;  // the step whose a-tile is in a_s

  const int gs = team.group_size(L);
  for (;;) {
    const long long g0 = (long long)gs * team.grab(work, &grab_sh);
    if (g0 >= L) break;
    // lane l looks up pair g0 + l; the team then takes the live ones
    const long long f = g0 + lane;
    const bool valid = lane < gs && f < L;
    int slot = 0, t = 0, bmt = 0, tj = Tb;
    if (valid) {
      slot = (int)(f / R);
      t = (int)(f - (long long)slot * R);
      const int word = bm[(size_t)(t / TPW) * SW + slot];
      bmt = (word >> (NB * (t % TPW))) & ((1 << NB) - 1);
      tj = (run_idx[slot] & 0xFFFF) * R + t;
    }
    unsigned todo = __ballot_sync(FULL, valid && bmt != 0 && tj < Tb);
    int my_c = 0, my_m = 0;
    while (todo) {  // uniform over the team
      const int q = __ffs(todo) - 1;
      todo &= todo - 1;
      const int slot_q = __shfl_sync(FULL, slot, q);
      const int t_q = __shfl_sync(FULL, t, q);
      const int bmt_q = __shfl_sync(FULL, bmt, q);
      const int tj_q = __shfl_sync(FULL, tj, q);
      const int s = slot_q / W;
      if (s != loaded) {
        team.sync();  // the previous step's readers are done with a_s
        ti = a_idx[s];
#pragma unroll
        for (int m = 0; m < K; ++m) {
          T a[4 * RA];
          ibvh::load_a_rec<KIND>(a_fields, Ta, G, ti, jc[m], a);
          ibvh::store_rec<RA>(a_s, jc[m], a);
        }
        team.sync();
        loaded = s;
      }
      T b[K][4 * RB];
#pragma unroll
      for (int m = 0; m < K; ++m)
        ibvh::load_b_rec<KIND>(b_fields, Tb, G, tj_q, jc[m], b[m]);
      int c[K], sw[K];
#pragma unroll
      for (int m = 0; m < K; ++m) c[m] = sw[m] = 0;
      const bool diag = dedup && tj_q == ti;
      int bits = bmt_q;
      while (bits) {  // each run of adjacent live bands as one loop
        const int r0 = __ffs(bits) - 1;
        const int len = __ffs(~(bits >> r0)) - 1;
        bits &= ~(((1 << len) - 1) << r0);
        const int i0 = r0 * BH, i1 = (r0 + len) * BH;
        if (diag)
          count_rows<T, KIND, K, MOMENTS, true>(a_s, i0, min(i1, jc[K - 1]),
                                                b, jc, c, sw);
        else
          count_rows<T, KIND, K, MOMENTS, false>(a_s, i0, i1, b, jc, c, sw);
      }
      if constexpr (MOMENTS) {
        int* wrd = words + ((size_t)slot_q * R + t_q) * WORD_LANES;
#pragma unroll
        for (int m = 0; m < K; ++m)
          wrd[jc[m]] = (c[m] << 23) | (c[m] <= 2 ? sw[m] : 0);
        for (int k = G + p; k < WORD_LANES; k += N) wrd[k] = 0;
      }
      int cs = 0, cm = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        cs += c[m];
        cm = max(cm, c[m]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        cs += __shfl_xor_sync(FULL, cs, o);
        cm = max(cm, __shfl_xor_sync(FULL, cm, o));
      }
      if constexpr (!WARP) {  // across the warps of the team
        if (lane == 0) {
          part[warp] = cs;
          part[NWP + warp] = cm;
        }
        __syncthreads();
        cs = cm = 0;
        for (int w = 0; w < NWP; ++w) {
          cs += part[w];
          cm = max(cm, part[NWP + w]);
        }
        __syncthreads();  // the partials are reused by the next pair
      }
      if (lane == q) {
        my_c = cs;
        my_m = cm;
      }
    }
    if (valid && writer) {  // dead pairs of live steps write zeros here
      counts[f] = my_c;
      colmax[f] = my_m;
    }
  }
  // the pairs of dead steps
  const long long live = (long long)live_steps * W * R;
  const long long all = (long long)S_cap * W * R;
  ibvh::grid_zero(counts, live, all);
  ibvh::grid_zero(colmax, live, all);
}

template <typename T, int KIND, int K, bool WARP>
void launch_kind(bool moments, const void* a_idx, const void* run_idx,
                 const void* bm, const void* nsteps, const void* a_fields,
                 const void* b_fields, void* counts, void* colmax,
                 void* words, void* work, int S_cap, int W, int R, int NB,
                 int Ta, int Tb, int G, int dedup, cudaStream_t stream) {
  auto kern = moments ? run_counts_kernel<T, KIND, K, true, WARP>
                      : run_counts_kernel<T, KIND, K, false, WARP>;
  // teams of one warp go WARP_TEAMS to a block; a larger team is the block
  const int threads = WARP ? 32 * ibvh::WARP_TEAMS : G / K;
  const int teams = threads / (G / K);
  const size_t shmem =
      (size_t)teams * G * ibvh::Rec<KIND>::RA * sizeof(ibvh::rec_t<T>) +
      (WARP ? 0 : 2 * (size_t)(threads / 32) * sizeof(int));
  const long long pairs = (long long)S_cap * W * R;
  const int blocks = ibvh::persistent_blocks(kern, threads, shmem,
                                             (pairs + teams - 1) / teams);
  kern<<<blocks, threads, shmem, stream>>>(
      (const int*)a_idx, (const int*)run_idx, (const int*)bm,
      (const int*)nsteps, (const T*)a_fields, (const T*)b_fields,
      (int*)counts, (int*)colmax, (int*)words, (int*)work, S_cap, W, R, NB,
      Ta, Tb, dedup);
}

}  // namespace

// a_idx: (S_cap,) i32; run_idx: (S_cap*W,) i32; bm: (R*NB/32, S_cap*W) i32
// band words; nsteps: (1,) i32; a_fields: (FA, Ta, G); b_fields: (FB, Tb,
// G) (may be a_fields); both float (value_bits 32) or double (64);
// counts, colmax: (S_cap*W*R,) i32, 16-byte aligned; words: (S_cap*W*R, 128) i32 or null (no moments; with
// moments G <= 128; only the rows of live pairs are written); work: (1,)
// i32, zeroed by the caller.  kind: 0 sphere, 1 box, 2 ray_box, 3
// ray_sphere.  G is the tile size (a multiple of 32, at most 1024).
// Returns cudaGetLastError().
extern "C" int run_counts_launch(const void* a_idx, const void* run_idx,
                                 const void* bm, const void* nsteps,
                                 const void* a_fields, const void* b_fields,
                                 void* counts, void* colmax, void* words,
                                 void* work, int S_cap, int W, int R, int NB,
                                 int Ta, int Tb, int G, int kind, int dedup,
                                 int value_bits, void* stream) {
  if (G % 32 != 0 || G < 32 || G > 1024 || NB < 1 || 32 % NB != 0 ||
      G % NB != 0 || R < 1 || R > 32 || R % (32 / NB) != 0 || W < 1 ||
      (words != nullptr && G > WORD_LANES) ||
      ((size_t)counts & 15) != 0 || ((size_t)colmax & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (S_cap > 0) {
    IBVH_DISPATCH_VALUE(
        value_bits,
        IBVH_DISPATCH_KIND(kind, IBVH_DISPATCH_TEAM(
            G, launch_kind, words != nullptr, a_idx, run_idx, bm, nsteps,
            a_fields, b_fields, counts, colmax, words, work, S_cap, W, R, NB,
            Ta, Tb, G, dedup, (cudaStream_t)stream)))
  }
  return (int)cudaGetLastError();
}
