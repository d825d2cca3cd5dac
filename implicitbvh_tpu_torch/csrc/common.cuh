// Shared device helpers of the tile-contact kernels and the walk kernels.
//
// Every float operation of a predicate is an explicitly rounded intrinsic
// (no FMA contraction, whatever nvcc's -fmad setting): the JAX reference and
// the plain PyTorch versions round each multiply and add on its own, and a
// contact lying exactly on the boundary would otherwise flip.  Comparisons
// are plain <= / >=, so NaN fields (padded leaves and rays) never match.
//
// A mask kind names the predicate and the two field sets it reads (tiles of
// G entries, field-major): the a set's rows against the b set's columns.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace ibvh {

enum MaskKind : int { SPHERE = 0, BOX = 1, RAY_BOX = 2, RAY_SPHERE = 3 };
constexpr int N_MASK_KINDS = 4;

// FA: fields of an a-row in memory; AP: floats of a prepared a-row (what
// pair_hit reads); FB: fields of a b-leaf.
//   SPHERE      a, b = (x0, x1, x2, r)
//   BOX         a, b = (lo0, lo1, lo2, up0, up1, up2)
//   RAY_BOX     a = ray (p0, p1, p2, d0, d1, d2), prepared as
//               (p0, p1, p2, 1/d0, 1/d1, 1/d2); b = box
//   RAY_SPHERE  a = ray, prepared as (p0, p1, p2, d0, d1, d2, d.d);
//               b = sphere
template <int KIND>
struct Mask;
template <>
struct Mask<SPHERE> {
  static constexpr int FA = 4, AP = 4, FB = 4;
};
template <>
struct Mask<BOX> {
  static constexpr int FA = 6, AP = 6, FB = 6;
};
template <>
struct Mask<RAY_BOX> {
  static constexpr int FA = 6, AP = 6, FB = 6;
};
template <>
struct Mask<RAY_SPHERE> {
  static constexpr int FA = 6, AP = 7, FB = 4;
};

// Explicitly rounded operations of either precision: every kernel but the
// compaction runs in float or double.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// Sphere-sphere contact: dx*dx + dy*dy + dz*dz <= (ra + rb)^2, evaluated
// left to right as in implicitbvh_tpu/ops/tile_contact.py:_band_mask.
template <typename T>
__device__ __forceinline__ bool sphere_hit(const T* a, const T* b) {
  const T dx = sub_rn(a[0], b[0]);
  const T dy = sub_rn(a[1], b[1]);
  const T dz = sub_rn(a[2], b[2]);
  const T rr = add_rn(a[3], b[3]);
  const T d2 =
      add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
  return d2 <= mul_rn(rr, rr);
}

// Box-box overlap; a and b hold (lo0, lo1, lo2, up0, up1, up2).
template <typename T>
__device__ __forceinline__ bool box_hit(const T* a, const T* b) {
  return (a[3] >= b[0]) & (a[0] <= b[3]) & (a[4] >= b[1]) & (a[1] <= b[4]) &
         (a[5] >= b[2]) & (a[2] <= b[5]);
}

// The reference's select min/max, where(x < y, x, y) and where(x > y, x, y):
// a NaN in either operand returns y.  fminf/fmaxf drop a NaN operand
// instead, which changes the answer for a ray lying in a face plane with a
// zero direction component (0 * inf), so they must not be used here.
template <typename T>
__device__ __forceinline__ T min2(T x, T y) {
  return (x < y) ? x : y;
}
template <typename T>
__device__ __forceinline__ T max2(T x, T y) {
  return (x > y) ? x : y;
}

// Forward ray against box, slab test (_band_mask, ray_box): a holds
// (p0, p1, p2, 1/d0, 1/d1, 1/d2), b holds (lo0, lo1, lo2, up0, up1, up2).
template <typename T>
__device__ __forceinline__ bool ray_box_hit(const T* a, const T* b) {
  T tmin = 0, tmax = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T t1 = mul_rn(sub_rn(b[k], a[k]), a[3 + k]);
    const T t2 = mul_rn(sub_rn(b[3 + k], a[k]), a[3 + k]);
    const T lo = min2(t1, t2);
    const T hi = max2(t1, t2);
    tmin = (k == 0) ? lo : max2(tmin, lo);
    tmax = (k == 0) ? hi : min2(tmax, hi);
  }
  return (tmin <= tmax) & (tmax >= T(0));
}

// Forward ray against sphere, discriminant test (_band_mask, ray_sphere):
// a holds (p0, p1, p2, d0, d1, d2, qa = d.d), b holds (x0, x1, x2, r).
template <typename T>
__device__ __forceinline__ bool ray_sphere_hit(const T* a, const T* b) {
  const T po0 = sub_rn(a[0], b[0]);
  const T po1 = sub_rn(a[1], b[1]);
  const T po2 = sub_rn(a[2], b[2]);
  const T qb = mul_rn(
      T(2), add_rn(add_rn(mul_rn(po0, a[3]), mul_rn(po1, a[4])),
                   mul_rn(po2, a[5])));
  const T qc = sub_rn(
      add_rn(add_rn(mul_rn(po0, po0), mul_rn(po1, po1)), mul_rn(po2, po2)),
      mul_rn(b[3], b[3]));
  const T disc = sub_rn(mul_rn(qb, qb), mul_rn(mul_rn(T(4), a[6]), qc));
  return (disc >= T(0)) & ((qb <= T(0)) | (qc <= T(0)));
}

// One prepared a-row against one b-leaf, both in registers.
template <int KIND, typename T>
__device__ __forceinline__ bool pair_hit(const T* a, const T* b) {
  if constexpr (KIND == SPHERE) return sphere_hit(a, b);
  if constexpr (KIND == BOX) return box_hit(a, b);
  if constexpr (KIND == RAY_BOX) return ray_box_hit(a, b);
  if constexpr (KIND == RAY_SPHERE) return ray_sphere_hit(a, b);
  return false;
}

// Row i of a-tile ti (fields (FA, Ta, G)) prepared into a[AP].  The ray
// reciprocals are IEEE divisions, computed once per ray as in _acols.
template <int KIND, typename T>
__device__ __forceinline__ void load_a_row(const T* __restrict__ fields,
                                           int Ta, int G, int ti, int i,
                                           T* a) {
  constexpr int FA = Mask<KIND>::FA;
#pragma unroll
  for (int f = 0; f < FA; ++f) a[f] = fields[((size_t)f * Ta + ti) * G + i];
  if constexpr (KIND == RAY_BOX) {
#pragma unroll
    for (int k = 3; k < 6; ++k) a[k] = div_rn(T(1), a[k]);
  }
  if constexpr (KIND == RAY_SPHERE) {
    a[6] = add_rn(add_rn(mul_rn(a[3], a[3]), mul_rn(a[4], a[4])),
                  mul_rn(a[5], a[5]));
  }
}

// Leaf j of b-tile tj (fields (FB, Tb, G)) into b[FB].
template <int KIND, typename T>
__device__ __forceinline__ void load_b_leaf(const T* __restrict__ fields,
                                            int Tb, int G, int tj, int j,
                                            T* b) {
#pragma unroll
  for (int f = 0; f < Mask<KIND>::FB; ++f)
    b[f] = fields[((size_t)f * Tb + tj) * G + j];
}

// ---------------------------------------------------------------------------
// Records of the count, emit and slot kernels (B2 run_counts.cu, B3
// group_emit.cu, B4 group_contacts.cu), in float or double.  A prepared
// a-row or b-leaf is one or two records of four values, so that one
// broadcast shared load per record (a float4; two double2 in double)
// fetches it whole; every thread of a warp reads the same record.
// Factors that depend on one side only are computed once per row or leaf
// with the same rounded operation the predicate would apply per test:
//   SPHERE      a, b = (x0, x1, x2, r)
//   BOX         a, b = (lo0, lo1, lo2, up0 | up1, up2, 0, 0)
//   RAY_BOX     a = (p0, p1, p2, 1/d0 | 1/d1, 1/d2, 0, 0); b = box
//   RAY_SPHERE  a = (p0, p1, p2, d0 | d1, d2, 4 * (d.d), 0);
//               b = (x0, x1, x2, r * r)
// RA, RB: records of an a-row and of a b-leaf.
template <int KIND>
struct Rec {
  static constexpr int RA = KIND == SPHERE ? 1 : 2;
  static constexpr int RB = (KIND == SPHERE || KIND == RAY_SPHERE) ? 1 : 2;
};

// A record of four values of T in shared memory: a float4 (16 bytes), or
// two double2 (32 bytes; not a double4, whose alignment variants differ
// between CUDA 12 and 13).
struct alignas(16) Double4 {
  double2 lo, hi;
};
template <typename T>
struct RecWord;
template <>
struct RecWord<float> {
  using type = float4;
};
template <>
struct RecWord<double> {
  using type = Double4;
};
template <typename T>
using rec_t = typename RecWord<T>::type;

// Row i of a-tile ti into the record values a[4 * RA].
template <int KIND, typename T>
__device__ __forceinline__ void load_a_rec(const T* __restrict__ fields,
                                           int Ta, int G, int ti, int i,
                                           T* a) {
#pragma unroll
  for (int f = Mask<KIND>::AP; f < 4 * Rec<KIND>::RA; ++f) a[f] = T(0);
  load_a_row<KIND>(fields, Ta, G, ti, i, a);
  if constexpr (KIND == RAY_SPHERE) a[6] = mul_rn(T(4), a[6]);
}

// Leaf j of b-tile tj into the record values b[4 * RB].
template <int KIND, typename T>
__device__ __forceinline__ void load_b_rec(const T* __restrict__ fields,
                                           int Tb, int G, int tj, int j,
                                           T* b) {
#pragma unroll
  for (int f = Mask<KIND>::FB; f < 4 * Rec<KIND>::RB; ++f) b[f] = T(0);
  load_b_leaf<KIND>(fields, Tb, G, tj, j, b);
  if constexpr (KIND == RAY_SPHERE) b[3] = mul_rn(b[3], b[3]);
}

template <int NR>
__device__ __forceinline__ void store_rec(float4* s, int k, const float* v) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
    s[k * NR + r] = make_float4(v[4 * r], v[4 * r + 1], v[4 * r + 2],
                                v[4 * r + 3]);
}

template <int NR>
__device__ __forceinline__ void store_rec(Double4* s, int k,
                                          const double* v) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    s[k * NR + r].lo = make_double2(v[4 * r], v[4 * r + 1]);
    s[k * NR + r].hi = make_double2(v[4 * r + 2], v[4 * r + 3]);
  }
}

template <int NR>
__device__ __forceinline__ void load_rec(const float4* s, int k, float* v) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float4 x = s[k * NR + r];
    v[4 * r] = x.x;
    v[4 * r + 1] = x.y;
    v[4 * r + 2] = x.z;
    v[4 * r + 3] = x.w;
  }
}

template <int NR>
__device__ __forceinline__ void load_rec(const Double4* s, int k, double* v) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const double2 x = s[k * NR + r].lo;
    const double2 y = s[k * NR + r].hi;
    v[4 * r] = x.x;
    v[4 * r + 1] = x.y;
    v[4 * r + 2] = y.x;
    v[4 * r + 3] = y.y;
  }
}

// ray_sphere_hit on records: the same operations in the same order, with
// 4 * (d.d) and r * r taken from the records.
template <typename T>
__device__ __forceinline__ bool ray_sphere_rec_hit(const T* a, const T* b) {
  const T po0 = sub_rn(a[0], b[0]);
  const T po1 = sub_rn(a[1], b[1]);
  const T po2 = sub_rn(a[2], b[2]);
  const T qb = mul_rn(
      T(2), add_rn(add_rn(mul_rn(po0, a[3]), mul_rn(po1, a[4])),
                   mul_rn(po2, a[5])));
  const T qc = sub_rn(
      add_rn(add_rn(mul_rn(po0, po0), mul_rn(po1, po1)), mul_rn(po2, po2)),
      b[3]);
  const T disc = sub_rn(mul_rn(qb, qb), mul_rn(a[6], qc));
  return (disc >= T(0)) & ((qb <= T(0)) | (qc <= T(0)));
}

// One a-record against one b-record, both in registers.
template <int KIND, typename T>
__device__ __forceinline__ bool rec_hit(const T* a, const T* b) {
  if constexpr (KIND == RAY_SPHERE) return ray_sphere_rec_hit(a, b);
  return pair_hit<KIND>(a, b);
}

// Columns (B2) or rows (B4) per thread: the largest of 4, 2, 1 that keeps
// a team (G / k threads) a multiple of 32.
inline int per_thread_of(int G) {
  return G % 128 == 0 ? 4 : G % 64 == 0 ? 2 : 1;
}

// Zeroes p[begin, end) with the whole grid, 16 bytes a store where
// aligned (p itself 16-byte aligned).
__device__ __forceinline__ void grid_zero(int* p, long long begin,
                                          long long end) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthr = (long long)gridDim.x * blockDim.x;
  const long long a = min(end, (begin + 3) & ~3LL);
  const long long e4 = end >> 2;
  for (long long i = begin + tid; i < a; i += nthr) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p);
  for (long long i = (a >> 2) + tid; i < e4; i += nthr)
    q[i] = make_int4(0, 0, 0, 0);
  for (long long i = max(a, e4 << 2) + tid; i < end; i += nthr) p[i] = 0;
}

// Block-wide exclusive prefix sum of K ints per thread, in (k, thread)
// order: value k of thread t is element k * blockDim.x + t.  Returns the
// total.  blockDim.x is a multiple of 32 and K * blockDim.x / 32 <= 32;
// `sh` holds 32 ints.
template <int K>
__device__ __forceinline__ int block_exclusive_scan_k(const int (&v)[K],
                                                      int (&off)[K],
                                                      int* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = v[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x[k], o);
      if (lane >= o) x[k] += y;
    }
    if (lane == 31) sh[k * nw + warp] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
    int w = lane < K * nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < K * nw) sh[lane] = w;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = k * nw + warp;
    off[k] = (q > 0 ? sh[q - 1] : 0) + x[k] - v[k];
  }
  return sh[K * nw - 1];
}

// Exclusive prefix sum of K ints per lane over one warp, in (k, lane)
// order; returns the total (in every lane).
template <int K>
__device__ __forceinline__ int warp_exclusive_scan_k(const int (&v)[K],
                                                     int (&off)[K]) {
  const int lane = threadIdx.x & 31;
  int run = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int x = v[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    off[k] = run + x - v[k];
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  return run;
}

// A team of the count, emit and slot kernels: the threads that take one
// tile pair together, G / k of them.  A team of one warp (tiles of 32, 64 and
// 128) is a worker of its own, several to a block, and syncs as a warp; a
// larger team is the whole block.  Teams take groups of up to 32 items in
// turn from a counter in device memory, zeroed by the caller, so that the
// grid balances itself as a grid of one block per item would; a group is
// smaller where the items are few, so that every team gets several.
constexpr int WARP_TEAMS = 4;  // teams of one warp in a block

template <bool WARP>
struct Team {
  // items per group, for n items over the grid's teams
  __device__ __forceinline__ int group_size(long long n) const {
    const long long teams =
        (long long)gridDim.x * (WARP ? blockDim.x >> 5 : 1);
    return (int)max(1LL, min(32LL, n / (4 * teams)));
  }
  __device__ __forceinline__ int rank() const {  // the thread in the team
    return WARP ? threadIdx.x & 31 : threadIdx.x;
  }
  __device__ __forceinline__ int index() const {  // the team in its block
    return WARP ? threadIdx.x >> 5 : 0;
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (WARP)
      __syncwarp();
    else
      __syncthreads();
  }
  // the team's next group of items; `sh` is one shared int of the block
  __device__ __forceinline__ int grab(int* work, int* sh) const {
    if constexpr (WARP) {
      int g = 0;
      if ((threadIdx.x & 31) == 0) g = atomicAdd(work, 1);
      return __shfl_sync(0xffffffffu, g, 0);
    } else {
      __syncthreads();  // every thread has read the previous group
      if (threadIdx.x == 0) *sh = atomicAdd(work, 1);
      __syncthreads();
      return *sh;
    }
  }
};

// Blocks of a persistent grid: as many as fit on the device at once, at
// most `cap`.  Cached per (kernel, device, block, shared memory).  A kernel
// that asks for more dynamic shared memory than its limit (48 KB in all by
// default; the slot kernels' records at tiles above 768, 1024 for
// ray_sphere) is first opted in to the device's per-block maximum, so that
// every tile size launches.
template <typename Kern>
inline int persistent_blocks(Kern kern, int threads, size_t shmem,
                             long long cap) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key =
      std::make_tuple(reinterpret_cast<const void*>(kern), dev, threads, shmem);
  int full;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it == cache.end()) {
      int sms = 0, per = 0;
      cudaFuncAttributes attr{};
      cudaFuncGetAttributes(&attr, kern);
      if (shmem > (size_t)attr.maxDynamicSharedSizeBytes) {
        // opt in to the device's limit less the kernel's static shared
        // memory: the most dynamic shared memory a block may take
        int most = 0;
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
      }
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads,
                                                    shmem);
      it = cache.emplace(key, std::max(1, sms) * std::max(1, per)).first;
    }
    full = it->second;
  }
  return (int)std::max(1LL, std::min((long long)full, cap));
}

// ---------------------------------------------------------------------------
// Volume records of the walk kernels (W1 walk.cu, W2 dfs.cu), one row per
// volume as ops/walk.py packs them, in float or double: a sphere (x0, x1,
// x2, r) is 4 values, a box (lo0, lo1, lo2, up0, up1, up2, 0, 0) 8, read
// 16 bytes a load.  Into v[4] or v[6].
template <int KIND, typename T>
__device__ __forceinline__ void load_volume(const T* __restrict__ recs,
                                            long long i, T* v) {
  constexpr int N = KIND == SPHERE ? 4 : 6;
  if constexpr (sizeof(T) == 4) {
    const float4* r = reinterpret_cast<const float4*>(recs) +
                      (KIND == SPHERE ? i : 2 * i);
    const float4 a = __ldg(r);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    if constexpr (N == 6) {
      const float4 b = __ldg(r + 1);
      v[4] = b.x;
      v[5] = b.y;
    }
  } else {
    const double2* r = reinterpret_cast<const double2*>(recs) +
                       (KIND == SPHERE ? 2 * i : 4 * i);
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {
      const double2 a = __ldg(r + h);
      v[2 * h] = a.x;
      v[2 * h + 1] = a.y;
    }
  }
}

// The box of a sphere s = (x0, x1, x2, r): c - r and c + r, each rounded
// on its own (volumes.bbox_of_bsphere).
template <typename T>
__device__ __forceinline__ void box_of_sphere(const T* s, T* b) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = sub_rn(s[k], s[3]);
    b[3 + k] = add_rn(s[k], s[3]);
  }
}

// volumes.iscontact of two volumes of kinds KA and KB: spheres by
// sphere_hit, anything else by box_hit, a sphere through its box.
template <int KA, int KB, typename T>
__device__ __forceinline__ bool volumes_hit(const T* a, const T* b) {
  if constexpr (KA == SPHERE && KB == SPHERE) {
    return sphere_hit(a, b);
  } else {
    T ab[6], bb[6];
    const T* pa = a;
    const T* pb = b;
    if constexpr (KA == SPHERE) {
      box_of_sphere(a, ab);
      pa = ab;
    }
    if constexpr (KB == SPHERE) {
      box_of_sphere(b, bb);
      pb = bb;
    }
    return box_hit(pa, pb);
  }
}

// The next item of a work list for the calling thread, from a counter in
// device memory zeroed by the caller: the threads of a warp that ask
// together take consecutive items with one atomic (the walk kernels' grids
// take items this way, so that no SM idles while items remain).
__device__ __forceinline__ int next_item(int* counter) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// The SM the calling thread runs on (the walk kernels' diagnostic variants
// record which SMs took items).
__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// Work counters of one walk or work item of the walk kernels' diagnostic
// variants (steps, node tests, leaf tests; the other variants count
// nothing).
struct WalkCounts {
  int steps = 0, node_tests = 0, leaf_tests = 0;
};

// Adds a walk or item of lane k to diag, (K + 2, 4) int32 zeroed by the
// launcher: lane k's steps, node tests and leaf tests summed over its
// walks, and its longest walk, in row k; then the bits of the SMs that ran
// one (five words), the walks, those that ran on in place (W2's items
// that found the work list full), and the largest grid (blocks) that ran
// one.
__device__ __forceinline__ void walk_diag(int* diag, int K, int k,
                                          const WalkCounts& c,
                                          bool in_place) {
  int* row = diag + 4LL * k;
  atomicAdd(row, c.steps);
  atomicAdd(row + 1, c.node_tests);
  atomicAdd(row + 2, c.leaf_tests);
  atomicMax(row + 3, c.steps);
  int* tail = diag + 4LL * K;
  const unsigned sm = sm_id();
  if (sm < 160) atomicOr((unsigned*)tail + (sm >> 5), 1u << (sm & 31));
  atomicAdd(tail + 5, 1);
  if (in_place) atomicAdd(tail + 6, 1);
  atomicMax(tail + 7, (int)gridDim.x);
}

// Calls FN<T, KIND, k, WARP>(...) with k = per_thread_of(G) and WARP set
// when a team of G / k threads is one warp.
#define IBVH_DISPATCH_TEAM(G, FN, ...)                  \
  {                                                     \
    const int k_ = ibvh::per_thread_of(G);              \
    const bool warp_ = (G) / k_ == 32;                  \
    if (k_ == 4 && warp_)                               \
      FN<T, KIND, 4, true>(__VA_ARGS__);                \
    else if (k_ == 4)                                   \
      FN<T, KIND, 4, false>(__VA_ARGS__);               \
    else if (k_ == 2 && warp_)                          \
      FN<T, KIND, 2, true>(__VA_ARGS__);                \
    else if (k_ == 2)                                   \
      FN<T, KIND, 2, false>(__VA_ARGS__);               \
    else if (warp_)                                     \
      FN<T, KIND, 1, true>(__VA_ARGS__);                \
    else                                                \
      FN<T, KIND, 1, false>(__VA_ARGS__);               \
  }

// Runs the body with the value type T set from `value_bits` (32: float,
// 64: double); other values return cudaErrorInvalidValue from the
// enclosing function.
#define IBVH_DISPATCH_VALUE(value_bits, ...)           \
  if ((value_bits) == 32) {                            \
    using T = float;                                   \
    __VA_ARGS__;                                       \
  } else if ((value_bits) == 64) {                     \
    using T = double;                                  \
    __VA_ARGS__;                                       \
  } else {                                             \
    return (int)cudaErrorInvalidValue;                 \
  }

// Runs `body` with the compile-time constant KIND set from `kind`; an
// unknown kind returns cudaErrorInvalidValue from the enclosing function.
#define IBVH_DISPATCH_KIND(kind, ...)                  \
  switch (kind) {                                      \
    case ibvh::SPHERE: {                               \
      constexpr int KIND = ibvh::SPHERE;               \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case ibvh::BOX: {                                  \
      constexpr int KIND = ibvh::BOX;                  \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case ibvh::RAY_BOX: {                              \
      constexpr int KIND = ibvh::RAY_BOX;              \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    case ibvh::RAY_SPHERE: {                           \
      constexpr int KIND = ibvh::RAY_SPHERE;           \
      __VA_ARGS__;                                     \
      break;                                           \
    }                                                  \
    default:                                           \
      return (int)cudaErrorInvalidValue;               \
  }

}  // namespace ibvh
