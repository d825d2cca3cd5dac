// Dense contact stream of the pre-counted tile pairs.
//
// Replaces implicitbvh_tpu/ops/tile_contact.py:tile_group_emit
// (_group_emit_kernel, _pair_compact_vrows, _stream_flush) on all four masks
// (sphere, box, ray_box, ray_sphere), with one or two field sets, in float or
// double (the fields' type; both sets of one type).  Entry e of
// the emit list packs tj | band << 16 | cnt << 20 | okc << 28 and pairs
// a-tile ti = a_idx[e / W] of the a set with b-tile tj of the b set; the
// entries of steps at or past nsteps (read on the device) are dead.  A live
// entry (cnt > 0) owns the output range [offs[e], offs[e] + lim), lim =
// min(cnt, CAP_PAIR), offs the exclusive prefix of lim over the live
// entries, which replaces the TPU's SMEM cursor and aligned flushes.  Its
// contacts go there as global sorted positions (ti*G + i, tj*G + j), in
// column-major order; writes stop at lim and at `cap`.  An entry with
// cnt >= 2 and okc == 0 (a "slow" pair) sets flag bit 1 when a row holds
// more than ROW_CAP contacts, as the TPU kernel's one-hot compaction does
// (with a ray mask a row is a ray).  ti and tj are compared only under
// `dedup` (one field set).
//
// Bound on the H100: operations, the live bands' explicitly rounded leaf
// tests of the live entries (a few MB of traffic beside them; 1-3 us of
// bytes at the ray scenes, where few entries are live).  The kernel of one
// block per entry of the whole S_cap * W grid (49,152 blocks at the 1M
// self scene, 393,216 at the ray scene, nearly all returning at once, each
// live one loading its a-tile itself and testing every row twice) took
// 0.68-1.09 ms on an H100.  The design:
//
// - emit_plan_kernel, one block, scans the live steps' entries in chunks
//   (16 a thread, the block's sums scanned as 64-bit pairs) and writes the
//   plan: the total, flag bit 0 (total > cap), the count of live entries,
//   the work counter's zero, and the list of live entries with their
//   offsets.  Nothing syncs with the host; it replaces the wrapper's torch
//   ops (cumsum, compares, zeros) of the old design.
// - group_emit_kernel runs a persistent grid over the listed entries only:
//   teams of G/k threads (a warp at tiles 32-128, four to a block; the
//   block above) take groups of them from the counter (Team, grab), as the
//   count and slot kernels do.  The team keeps its a-tile as records of
//   four values (16 bytes, 32 in double) in shared memory until ti changes, so a step's entries load it
//   once; each thread holds the records of its k b-columns j = p + m*G/k
//   in registers, so one broadcast load of an a-row feeds k tests, and
//   (m, p) order is column order: one team scan (warp_exclusive_scan_k,
//   block_exclusive_scan_k) gives each column's offset within the pair.
// - One pass of the tests counts each column and keeps its first two hit
//   rows in registers.  A column that writes at most two contacts (every
//   column of an okc entry) writes them from there; only a column that
//   writes more is tested again, and stops at lim.  A slow entry
//   counts its rows with warp ballots in the same pass (summed in shared
//   memory when the team is a block).  The predicates are rec_hit, as in
//   the count and slot kernels, built with -fmad=false.
// - The grid zeroes both streams from the total to `cap`, and a live
//   entry with fewer contacts than lim zeroes the rest of its range, so
//   the outputs are allocated uninitialised.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int EMIT_BANDS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_ITEMS = 16;  // entries per thread per chunk
// plan layout (int32): total, flags, live entries, work counter, then
// (entry, offset) pairs
constexpr int PLAN_HEAD = 4;

// Block-wide exclusive prefix sum of one 64-bit value per thread; returns
// the total.  `sh` holds 32 values.
__device__ __forceinline__ long long block_scan64(long long v, long long* sh,
                                                  long long* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  const long long before = (warp > 0 ? sh[warp - 1] : 0) + x - v;
  *total = sh[nw - 1];
  __syncthreads();  // sh is reused by the next chunk
  return before;
}

__global__ void __launch_bounds__(PLAN_THREADS)
    emit_plan_kernel(const int* __restrict__ b_idx,
                     const int* __restrict__ nsteps, int* __restrict__ plan,
                     int S_cap, int W, int cap_pair, int cap) {
  __shared__ long long sh[32];
  int2* pairs = reinterpret_cast<int2*>(plan + PLAN_HEAD);
  const long long n =
      (long long)max(0, min(nsteps[0], S_cap)) * (long long)W;
  long long carry = 0;  // (offset << 32) | live entries, before the chunk
  for (long long c0 = 0; c0 < n; c0 += (long long)PLAN_THREADS * PLAN_ITEMS) {
    const long long e0 = c0 + (long long)threadIdx.x * PLAN_ITEMS;
    int lim[PLAN_ITEMS];
    int s_lim = 0, s_live = 0;
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      lim[i] = e0 + i < n ? min((b_idx[e0 + i] >> 20) & 0xFF, cap_pair) : 0;
      s_lim += lim[i];
      s_live += lim[i] > 0;
    }
    long long total;
    const long long before =
        carry + block_scan64(((long long)s_lim << 32) | s_live, sh, &total);
    int off = (int)(before >> 32), k = (int)(before & 0xffffffffLL);
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      if (lim[i] > 0) {
        pairs[k] = make_int2((int)(e0 + i), off);
        ++k;
        off += lim[i];
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    const int total = (int)(carry >> 32);
    plan[0] = total;
    plan[1] = total > cap;
    plan[2] = (int)(carry & 0xffffffffLL);
    plan[3] = 0;
  }
}

// Pass 1 over a-rows [i0, i1) for the thread's K columns: counts c, the
// first two hit rows r0, r1 of each column, and for a slow entry (SLOW)
// the row counts: `big` is set when a row exceeds row_cap (warp teams:
// complete from the warp's ballots; a larger team adds each warp's count
// into rowcnt).  DIAG keeps i < j only.  The loop is uniform over the team.
template <typename T, int KIND, int K, bool WARP, bool DIAG, bool SLOW>
__device__ __forceinline__ void count_rows(
    const ibvh::rec_t<T>* a_s, int i0, int i1,
    const T (&b)[K][4 * ibvh::Rec<KIND>::RB], const int (&j)[K],
    int (&c)[K], int (&r0)[K], int (&r1)[K], int* rowcnt, int row_cap,
    bool& big) {
  constexpr int RA = ibvh::Rec<KIND>::RA;
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    T a[4 * RA];
    ibvh::load_rec<RA>(a_s, i, a);
    int n = 0;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      bool h = ibvh::rec_hit<KIND>(a, b[m]);
      if constexpr (DIAG) h = h && i < j[m];
      if (h) {
        r1[m] = c[m] == 1 ? i : r1[m];
        r0[m] = c[m] == 0 ? i : r0[m];
        ++c[m];
      }
      if constexpr (SLOW) n += __popc(__ballot_sync(FULL, h));
    }
    if constexpr (SLOW) {
      if constexpr (WARP) {
        big |= n > row_cap;
      } else {
        if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(&rowcnt[i], n);
      }
    }
  }
}

template <typename T, int KIND, int K, bool WARP, bool DIAG, bool SLOW>
__device__ __forceinline__ void count_bands(
    const ibvh::rec_t<T>* a_s, int bands, int BH, int G,
    const T (&b)[K][4 * ibvh::Rec<KIND>::RB], const int (&j)[K],
    int (&c)[K], int (&r0)[K], int (&r1)[K], int* rowcnt, int row_cap,
    bool& big) {
  while (bands) {  // each run of adjacent live bands as one loop
    const int q0 = __ffs(bands) - 1;
    const int len = __ffs(~(bands >> q0)) - 1;
    bands &= ~(((1 << len) - 1) << q0);
    // under DIAG no row reaches the last column: stop at G - 1 (uniform)
    const int i1 = DIAG ? min((q0 + len) * BH, G - 1) : (q0 + len) * BH;
    count_rows<T, KIND, K, WARP, DIAG, SLOW>(a_s, q0 * BH, i1, b, j, c, r0,
                                             r1, rowcnt, row_cap, big);
  }
}

template <typename T, int KIND, int K, bool WARP, bool DIAG>
__device__ __forceinline__ void count_entry(
    bool slow, const ibvh::rec_t<T>* a_s, int bands, int BH, int G,
    const T (&b)[K][4 * ibvh::Rec<KIND>::RB], const int (&j)[K],
    int (&c)[K], int (&r0)[K], int (&r1)[K], int* rowcnt, int row_cap,
    bool& big) {
  if (slow)
    count_bands<T, KIND, K, WARP, DIAG, true>(a_s, bands, BH, G, b, j, c,
                                              r0, r1, rowcnt, row_cap, big);
  else
    count_bands<T, KIND, K, WARP, DIAG, false>(a_s, bands, BH, G, b, j, c,
                                               r0, r1, rowcnt, row_cap, big);
}

template <typename T, int KIND, int K, bool WARP>
__global__ void group_emit_kernel(const int* __restrict__ a_idx,
                                  const int* __restrict__ b_idx,
                                  const T* __restrict__ a_fields,
                                  const T* __restrict__ b_fields,
                                  int* __restrict__ out,
                                  int* __restrict__ plan, int W, int Ta,
                                  int Tb, int dedup, int row_cap,
                                  int cap_pair, int cap) {
  constexpr int RA = ibvh::Rec<KIND>::RA, RB = ibvh::Rec<KIND>::RB;
  const ibvh::Team<WARP> team;
  const int N = WARP ? 32 : blockDim.x, G = N * K, p = team.rank();
  const int lane = threadIdx.x & 31;
  const int BH = G / EMIT_BANDS;
  extern __shared__ float4 smem[];
  ibvh::rec_t<T>* recs = reinterpret_cast<ibvh::rec_t<T>*>(smem);
  ibvh::rec_t<T>* a_s = recs + (size_t)team.index() * G * RA;  // [G][RA]
  // a larger team's row counts of a slow entry
  int* rowcnt = reinterpret_cast<int*>(recs + (size_t)G * RA);
  __shared__ int scan_sh[32];
  __shared__ int grab_sh;
  const int2* pairs = reinterpret_cast<const int2*>(plan + PLAN_HEAD);
  int* gi = out;
  int* gj = out + cap;
  const int n_live = plan[2];

  int jc[K];  // the thread's columns
#pragma unroll
  for (int m = 0; m < K; ++m) jc[m] = p + m * N;
  int loaded = -1;  // the a-tile held in a_s

  const int gs = team.group_size(n_live);
  for (;;) {
    const long long g0 = (long long)gs * team.grab(plan + 3, &grab_sh);
    if (g0 >= n_live) break;
    // lane l looks up listed entry g0 + l; the team takes them in turn
    const int n_q = (int)min((long long)gs, n_live - g0);
    int e = 0, off = 0, bw = 0, ti = 0;
    if (lane < n_q) {
      const int2 eo = pairs[g0 + lane];
      e = eo.x;
      off = eo.y;
      bw = b_idx[e];
      ti = a_idx[e / W];
    }
    for (int q = 0; q < n_q; ++q) {  // uniform over the team
      const int off_q = __shfl_sync(FULL, off, q);
      const int bw_q = __shfl_sync(FULL, bw, q);
      const int ti_q = __shfl_sync(FULL, ti, q);
      const int tj = bw_q & 0xFFFF;
      const int bands = (bw_q >> 16) & ((1 << EMIT_BANDS) - 1);
      const int cnt = (bw_q >> 20) & 0xFF;
      const bool slow = cnt >= 2 && ((bw_q >> 28) & 1) == 0;
      const int lim = min(cnt, cap_pair);
      int tot = 0;  // the entry's contacts (all of its columns)
      if (tj < Tb) {
        const int ta = min(ti_q, Ta - 1);
        if (ta != loaded) {
          team.sync();  // the previous entries' readers are done with a_s
#pragma unroll
          for (int m = 0; m < K; ++m) {
            T a[4 * RA];
            ibvh::load_a_rec<KIND>(a_fields, Ta, G, ta, jc[m], a);
            ibvh::store_rec<RA>(a_s, jc[m], a);
          }
          loaded = ta;
        }
        if (!WARP && slow) {  // a larger team counts rows in shared memory
          team.sync();  // the previous entry's readers are done
          for (int i = p; i < G; i += N) rowcnt[i] = 0;
        }
        team.sync();
        T b[K][4 * RB];
#pragma unroll
        for (int m = 0; m < K; ++m)
          ibvh::load_b_rec<KIND>(b_fields, Tb, G, tj, jc[m], b[m]);
        int c[K], r0[K], r1[K];
#pragma unroll
        for (int m = 0; m < K; ++m) c[m] = r0[m] = r1[m] = 0;
        bool big = false;
        if (dedup && tj == ti_q)
          count_entry<T, KIND, K, WARP, true>(slow, a_s, bands, BH, G, b, jc,
                                              c, r0, r1, rowcnt, row_cap,
                                              big);
        else
          count_entry<T, KIND, K, WARP, false>(slow, a_s, bands, BH, G, b, jc,
                                               c, r0, r1, rowcnt, row_cap,
                                               big);
        int coff[K];
        if constexpr (WARP) {
          tot = ibvh::warp_exclusive_scan_k<K>(c, coff);
        } else {
          tot = ibvh::block_exclusive_scan_k<K>(c, coff, scan_sh);
          if (slow) {  // the scan's barriers ordered the row counts
            for (int i = p; i < G; i += N) big |= rowcnt[i] > row_cap;
            big = __syncthreads_or(big);
          }
        }
        if (slow && big && p == 0) atomicOr(plan + 1, 2);

        const bool diag = dedup && tj == ti_q;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          if (c[m] == 0 || coff[m] >= lim) continue;
          const int n = min(c[m], lim - coff[m]);  // contacts to write
          const int o = off_q + coff[m];
          const int gjv = tj * G + jc[m];
          if (n <= 2) {  // the first two hit rows, kept in pass 1
            if (o < cap) {
              gi[o] = ti_q * G + r0[m];
              gj[o] = gjv;
            }
            if (n == 2 && o + 1 < cap) {
              gi[o + 1] = ti_q * G + r1[m];
              gj[o + 1] = gjv;
            }
            continue;
          }
          // more than two to write: test the column again, up to n hits
          int k = 0;
          int bl = bands;
          while (bl && k < n) {
            const int q0 = __ffs(bl) - 1;
            const int len = __ffs(~(bl >> q0)) - 1;
            bl &= ~(((1 << len) - 1) << q0);
            const int i1 = diag ? min((q0 + len) * BH, jc[m])
                                : (q0 + len) * BH;
#pragma unroll 1
            for (int i = q0 * BH; i < i1 && k < n; ++i) {
              T a[4 * RA];
              ibvh::load_rec<RA>(a_s, i, a);
              if (ibvh::rec_hit<KIND>(a, b[m])) {
                if (o + k < cap) {
                  gi[o + k] = ti_q * G + i;
                  gj[o + k] = gjv;
                }
                ++k;
              }
            }
          }
        }
      }
      // a range with fewer contacts than lim: zeros in the rest
      for (int s = off_q + tot + p; s < min(off_q + lim, cap); s += N) {
        gi[s] = 0;
        gj[s] = 0;
      }
    }
  }
  // both streams past the total
  const long long total = plan[0];
  if (total < cap) {
    ibvh::grid_zero(out, total, cap);
    ibvh::grid_zero(out, (long long)cap + total, 2LL * cap);
  }
}

template <typename T, int KIND, int K, bool WARP>
void launch_kind(const void* a_idx, const void* b_idx, const void* a_fields,
                 const void* b_fields, void* out, void* plan, int SW, int W,
                 int Ta, int Tb, int G, int dedup, int row_cap, int cap_pair,
                 int cap, cudaStream_t stream) {
  auto kern = group_emit_kernel<T, KIND, K, WARP>;
  // teams of one warp go WARP_TEAMS to a block; a larger team is the block
  const int threads = WARP ? 32 * ibvh::WARP_TEAMS : G / K;
  const int teams = threads / (G / K);
  const size_t shmem =
      (size_t)teams * G * ibvh::Rec<KIND>::RA * sizeof(ibvh::rec_t<T>) +
      (WARP ? 0 : (size_t)G * sizeof(int));
  const int blocks = ibvh::persistent_blocks(kern, threads, shmem,
                                             ((long long)SW + teams - 1) / teams);
  kern<<<blocks, threads, shmem, stream>>>(
      (const int*)a_idx, (const int*)b_idx, (const T*)a_fields,
      (const T*)b_fields, (int*)out, (int*)plan, W, Ta, Tb, dedup,
      row_cap, cap_pair, cap);
}

bool bad_plan_args(int S_cap, int W, int cap_pair, int cap, const void* plan) {
  return S_cap < 1 || W < 1 || cap_pair < 1 || cap < 1 ||
         ((size_t)plan & 7) != 0;
}

}  // namespace

// b_idx: (S_cap*W,) i32; nsteps: (1,) i32; plan: (4 + 2*S_cap*W,) i32,
// 8-byte aligned: the total, the flags (bit 0: total > cap), the number of
// live entries, the emit kernel's work counter (zeroed here), then the live
// entries and their offsets as (entry, offset) pairs.  Returns
// cudaGetLastError().
extern "C" int emit_plan_launch(const void* b_idx, const void* nsteps,
                                void* plan, int S_cap, int W, int cap_pair,
                                int cap, void* stream) {
  if (bad_plan_args(S_cap, W, cap_pair, cap, plan))
    return (int)cudaErrorInvalidValue;
  emit_plan_kernel<<<1, PLAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)b_idx, (const int*)nsteps, (int*)plan, S_cap, W, cap_pair,
      cap);
  return (int)cudaGetLastError();
}

// a_idx: (S_cap,) i32; b_idx: (S_cap*W,) i32; nsteps: (1,) i32; a_fields:
// (FA, Ta, G); b_fields: (FB, Tb, G) (may be a_fields); both float
// (value_bits 32) or double (64); out: (2*cap
// + 4 + 2*S_cap*W,) i32, 16-byte aligned: gi, gj, then the plan (as
// above; flag bit 1 set here).  Nothing needs zeroing.  kind: 0 sphere, 1
// box, 2 ray_box, 3 ray_sphere.  G is the tile size (a multiple of 32, at
// most 1024).  Two launches on the stream.  Returns cudaGetLastError().
extern "C" int group_emit_launch(const void* a_idx, const void* b_idx,
                                 const void* nsteps, const void* a_fields,
                                 const void* b_fields, void* out, int S_cap,
                                 int W, int Ta, int Tb, int G, int kind,
                                 int dedup, int row_cap, int cap_pair,
                                 int cap, int value_bits, void* stream) {
  int* plan = (int*)out + 2 * (size_t)cap;
  if (G % 32 != 0 || G < 32 || G > 1024 || ((size_t)out & 15) != 0 ||
      (value_bits != 32 && value_bits != 64) ||
      bad_plan_args(S_cap, W, cap_pair, cap, plan))
    return (int)cudaErrorInvalidValue;
  const int err = emit_plan_launch(b_idx, nsteps, plan, S_cap, W, cap_pair,
                                   cap, stream);
  if (err != 0) return err;
  const int SW = S_cap * W;
  IBVH_DISPATCH_VALUE(
      value_bits,
      IBVH_DISPATCH_KIND(kind, IBVH_DISPATCH_TEAM(
          G, launch_kind, a_idx, b_idx, a_fields, b_fields, out, plan, SW,
          W, Ta, Tb, G, dedup, row_cap, cap_pair, cap,
          (cudaStream_t)stream)))
  return (int)cudaGetLastError();
}
