// Shared device helpers of the tile-contact kernels.
//
// Every float operation of a predicate is an explicitly rounded intrinsic
// (no FMA contraction, whatever nvcc's -fmad setting): the JAX reference and
// the plain PyTorch versions round each multiply and add on its own, and a
// contact lying exactly on the boundary would otherwise flip.  Comparisons
// are plain <= / >=, so NaN fields (padded leaves) never match.
#pragma once

#include <cuda_runtime.h>

namespace ibvh {

// Sphere-sphere contact: dx*dx + dy*dy + dz*dz <= (ra + rb)^2, evaluated
// left to right as in implicitbvh_tpu/ops/tile_contact.py:_band_mask.
__device__ __forceinline__ bool sphere_hit(float ax, float ay, float az,
                                           float ar, float bx, float by,
                                           float bz, float br) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  const float rr = __fadd_rn(ar, br);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= __fmul_rn(rr, rr);
}

// Box-box overlap; a and b hold (lo0, lo1, lo2, up0, up1, up2).
__device__ __forceinline__ bool box_hit(const float* a, const float* b) {
  return (a[3] >= b[0]) & (a[0] <= b[3]) & (a[4] >= b[1]) & (a[1] <= b[4]) &
         (a[5] >= b[2]) & (a[2] <= b[5]);
}

// Leaf i of the a-tile (fields in shared memory, field-major with pitch G)
// against this thread's b-leaf (fields in registers).
template <bool BOX>
__device__ __forceinline__ bool leaf_hit(const float* a_s, int G, int i,
                                         const float* b) {
  if constexpr (BOX) {
    float a[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) a[f] = a_s[f * G + i];
    return box_hit(a, b);
  }
  return sphere_hit(a_s[i], a_s[G + i], a_s[2 * G + i], a_s[3 * G + i], b[0],
                    b[1], b[2], b[3]);
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
