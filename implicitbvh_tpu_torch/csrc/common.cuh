// Shared device helpers of the tile-contact kernels.
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

#include <cuda_runtime.h>

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

// Host-side copies of AP and FB (shared-memory sizes of the launchers).
inline int prepared_a_floats(int kind) {
  return kind == SPHERE ? 4 : kind == RAY_SPHERE ? 7 : 6;
}
inline int b_fields_of(int kind) {
  return (kind == SPHERE || kind == RAY_SPHERE) ? 4 : 6;
}

// Sphere-sphere contact: dx*dx + dy*dy + dz*dz <= (ra + rb)^2, evaluated
// left to right as in implicitbvh_tpu/ops/tile_contact.py:_band_mask.
__device__ __forceinline__ bool sphere_hit(const float* a, const float* b) {
  const float dx = __fsub_rn(a[0], b[0]);
  const float dy = __fsub_rn(a[1], b[1]);
  const float dz = __fsub_rn(a[2], b[2]);
  const float rr = __fadd_rn(a[3], b[3]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= __fmul_rn(rr, rr);
}

// Box-box overlap; a and b hold (lo0, lo1, lo2, up0, up1, up2).
__device__ __forceinline__ bool box_hit(const float* a, const float* b) {
  return (a[3] >= b[0]) & (a[0] <= b[3]) & (a[4] >= b[1]) & (a[1] <= b[4]) &
         (a[5] >= b[2]) & (a[2] <= b[5]);
}

// The reference's select min/max, where(x < y, x, y) and where(x > y, x, y):
// a NaN in either operand returns y.  fminf/fmaxf drop a NaN operand
// instead, which changes the answer for a ray lying in a face plane with a
// zero direction component (0 * inf), so they must not be used here.
__device__ __forceinline__ float min2(float x, float y) {
  return (x < y) ? x : y;
}
__device__ __forceinline__ float max2(float x, float y) {
  return (x > y) ? x : y;
}

// Forward ray against box, slab test (_band_mask, ray_box): a holds
// (p0, p1, p2, 1/d0, 1/d1, 1/d2), b holds (lo0, lo1, lo2, up0, up1, up2).
__device__ __forceinline__ bool ray_box_hit(const float* a, const float* b) {
  float tmin = 0.f, tmax = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = __fmul_rn(__fsub_rn(b[k], a[k]), a[3 + k]);
    const float t2 = __fmul_rn(__fsub_rn(b[3 + k], a[k]), a[3 + k]);
    const float lo = min2(t1, t2);
    const float hi = max2(t1, t2);
    tmin = (k == 0) ? lo : max2(tmin, lo);
    tmax = (k == 0) ? hi : min2(tmax, hi);
  }
  return (tmin <= tmax) & (tmax >= 0.f);
}

// Forward ray against sphere, discriminant test (_band_mask, ray_sphere):
// a holds (p0, p1, p2, d0, d1, d2, qa = d.d), b holds (x0, x1, x2, r).
__device__ __forceinline__ bool ray_sphere_hit(const float* a,
                                               const float* b) {
  const float po0 = __fsub_rn(a[0], b[0]);
  const float po1 = __fsub_rn(a[1], b[1]);
  const float po2 = __fsub_rn(a[2], b[2]);
  const float qb = __fmul_rn(
      2.0f, __fadd_rn(__fadd_rn(__fmul_rn(po0, a[3]), __fmul_rn(po1, a[4])),
                      __fmul_rn(po2, a[5])));
  const float qc = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(po0, po0), __fmul_rn(po1, po1)),
                __fmul_rn(po2, po2)),
      __fmul_rn(b[3], b[3]));
  const float disc = __fsub_rn(__fmul_rn(qb, qb),
                               __fmul_rn(__fmul_rn(4.0f, a[6]), qc));
  return (disc >= 0.f) & ((qb <= 0.f) | (qc <= 0.f));
}

// One prepared a-row against one b-leaf, both in registers.
template <int KIND>
__device__ __forceinline__ bool pair_hit(const float* a, const float* b) {
  if constexpr (KIND == SPHERE) return sphere_hit(a, b);
  if constexpr (KIND == BOX) return box_hit(a, b);
  if constexpr (KIND == RAY_BOX) return ray_box_hit(a, b);
  if constexpr (KIND == RAY_SPHERE) return ray_sphere_hit(a, b);
  return false;
}

// Row i of a-tile ti (fields (FA, Ta, G)) prepared into a[AP].  The ray
// reciprocals are IEEE divisions, computed once per ray as in _acols.
template <int KIND>
__device__ __forceinline__ void load_a_row(const float* __restrict__ fields,
                                           int Ta, int G, int ti, int i,
                                           float* a) {
  constexpr int FA = Mask<KIND>::FA;
#pragma unroll
  for (int f = 0; f < FA; ++f) a[f] = fields[((size_t)f * Ta + ti) * G + i];
  if constexpr (KIND == RAY_BOX) {
#pragma unroll
    for (int k = 3; k < 6; ++k) a[k] = __fdiv_rn(1.0f, a[k]);
  }
  if constexpr (KIND == RAY_SPHERE) {
    a[6] = __fadd_rn(__fadd_rn(__fmul_rn(a[3], a[3]), __fmul_rn(a[4], a[4])),
                     __fmul_rn(a[5], a[5]));
  }
}

// Leaf j of b-tile tj (fields (FB, Tb, G)) into b[FB].
template <int KIND>
__device__ __forceinline__ void load_b_leaf(const float* __restrict__ fields,
                                            int Tb, int G, int tj, int j,
                                            float* b) {
#pragma unroll
  for (int f = 0; f < Mask<KIND>::FB; ++f)
    b[f] = fields[((size_t)f * Tb + tj) * G + j];
}

// Row i of the prepared a-tile (shared memory, field-major with pitch G)
// against this thread's b-leaf (registers).
template <int KIND>
__device__ __forceinline__ bool leaf_hit(const float* a_s, int G, int i,
                                         const float* b) {
  float a[Mask<KIND>::AP];
#pragma unroll
  for (int f = 0; f < Mask<KIND>::AP; ++f) a[f] = a_s[f * G + i];
  return pair_hit<KIND>(a, b);
}

// This thread's prepared a-row (registers) against leaf j of the b-tile
// (shared memory, field-major with pitch G).
template <int KIND>
__device__ __forceinline__ bool row_hit(const float* a, const float* b_s,
                                        int G, int j) {
  float b[Mask<KIND>::FB];
#pragma unroll
  for (int f = 0; f < Mask<KIND>::FB; ++f) b[f] = b_s[f * G + j];
  return pair_hit<KIND>(a, b);
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

// Block-wide sum and max of one int per thread; the result is valid in
// thread 0.  blockDim.x is a multiple of 32; `sh` holds 64 ints.
__device__ __forceinline__ void block_sum_max(int v, int* sum, int* mx,
                                              int* sh) {
  int s = v, m = v;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with `sh`
  if (lane == 0) {
    sh[warp] = s;
    sh[32 + warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ts = 0, tm = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      ts += sh[w];
      tm = max(tm, sh[32 + w]);
    }
    *sum = ts;
    *mx = tm;
  }
}

// Block-wide exclusive prefix sum of one int per thread, in thread order.
// blockDim.x is a multiple of 32; `sh` holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) sh[lane] = w;
  }
  __syncthreads();
  return (warp > 0 ? sh[warp - 1] : 0) + x - v;
}

}  // namespace ibvh
