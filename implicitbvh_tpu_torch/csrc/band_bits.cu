// Phase-1b sub-band bits for every live supertile pair.
//
// Replaces implicitbvh_tpu/ops/subtile.py:subtile_band_bits (_bits_kernel).
// Block p handles superpair slot p; thread (i, j) of the 32 x 32 block builds
// the NB-bit word of a-tile si[p]*32+i against b-tile sj[p]*32+j: bit r is
// set iff sub-band r of the a-tile overlaps the b-tile's AABB.  Invalid
// entries (tile index past Ta/Tb, or i > j under `triangle`) and slots
// p >= nsp (read on the device) are written as 0.
//
// Bound on the H100: bytes.  Each slot reads 32 * NB * 6 + 32 * 6 floats of
// bounds (mostly from L2) and writes 4 KB of bits; the 6 * NB comparisons
// per word are negligible.  The design stages both supertiles' bounds in
// shared memory once per block, so every bound is read from device memory
// once per slot, and writes the output as (SP_cap, 32, 32) without the
// TPU's 96 dead lanes per row.
#include <cuda_runtime.h>

namespace {

constexpr int SS = 32;      // tiles per supertile
constexpr int MAX_NB = 16;  // sub-bands per tile (4, 8 or 16)

__global__ void band_bits_kernel(const float* __restrict__ sub,
                                 const float* __restrict__ tiles,
                                 const int* __restrict__ si,
                                 const int* __restrict__ sj,
                                 const int* __restrict__ nsp,
                                 int* __restrict__ out, int Ta, int Tb,
                                 int NB, int triangle) {
  __shared__ float a_s[6 * SS * MAX_NB];  // [bound][tile][band]
  __shared__ float b_s[6 * SS];           // [bound][tile]
  const int p = blockIdx.x;
  const int i = threadIdx.y, j = threadIdx.x;
  const int tid = i * SS + j;
  int* o = out + (size_t)p * SS * SS;
  if (p >= nsp[0]) {
    o[tid] = 0;
    return;
  }
  const int ta0 = si[p] * SS, tb0 = sj[p] * SS;
  for (int k = tid; k < 6 * SS * NB; k += SS * SS) {
    const int f = k / (SS * NB), rem = k - f * SS * NB;
    const int t = ta0 + rem / NB;
    a_s[k] = t < Ta ? sub[((size_t)f * Ta + t) * NB + rem % NB] : 0.f;
  }
  if (tid < 6 * SS) {
    const int f = tid / SS, t = tb0 + tid % SS;
    b_s[tid] = t < Tb ? tiles[(size_t)f * Tb + t] : 0.f;
  }
  __syncthreads();

  const int tii = ta0 + i, tjj = tb0 + j;
  int bits = 0;
  if (tii < Ta && tjj < Tb && (!triangle || tii <= tjj)) {
    float b[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) b[f] = b_s[f * SS + j];
    for (int r = 0; r < NB; ++r) {
      const float* a = a_s + i * NB + r;
      const int st = SS * NB;
      const bool ov = (a[3 * st] >= b[0]) & (a[0] <= b[3]) &
                      (a[4 * st] >= b[1]) & (a[st] <= b[4]) &
                      (a[5 * st] >= b[2]) & (a[2 * st] <= b[5]);
      bits |= (int)ov << r;
    }
  }
  o[tid] = bits;
}

}  // namespace

// sub: (6, Ta, NB) f32 sub-band bounds (lo0, lo1, lo2, up0, up1, up2);
// tiles: (6, Tb) f32 tile bounds; si, sj: (sp_cap,) i32; nsp: (1,) i32;
// out: (sp_cap, 32, 32) i32.  Returns cudaGetLastError().
extern "C" int band_bits_launch(const void* sub, const void* tiles,
                                const void* si, const void* sj,
                                const void* nsp, void* out, int sp_cap,
                                int Ta, int Tb, int NB, int triangle,
                                void* stream) {
  if (NB < 1 || NB > MAX_NB) return (int)cudaErrorInvalidValue;
  if (sp_cap > 0) {
    band_bits_kernel<<<sp_cap, dim3(SS, SS), 0, (cudaStream_t)stream>>>(
        (const float*)sub, (const float*)tiles, (const int*)si,
        (const int*)sj, (const int*)nsp, (int*)out, Ta, Tb, NB, triangle);
  }
  return (int)cudaGetLastError();
}
