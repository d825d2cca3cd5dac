// Phase-1b sub-band bits for every live supertile pair.
//
// Replaces implicitbvh_tpu/ops/subtile.py:subtile_band_bits (_bits_kernel).
// Slot p's output is a 32 x 32 grid of NB-bit words: word (i, j) belongs to
// a-tile si[p]*32+i against b-tile sj[p]*32+j, and its bit r is set iff
// sub-band r of the a-tile overlaps the b-tile's AABB.  Invalid entries
// (tile index past Ta/Tb, or i > j under `triangle`) and slots p >= nsp
// (read on the device) are written as 0.
//
// Bounds are float or double (the leaves' type; a float tree is widened
// exactly before a pair with a double one).
//
// Bound on the H100: bytes.  The output is 4 KB a slot, live or dead (25 MB
// at the 1M self scene's 6,144 slots), against 6 * NB * 32 + 6 * 32 values
// of bounds read per live slot (mostly from L2) and 6 * NB comparisons a
// word.  What held the first version back was latency, not bandwidth: one
// block of 1,024 threads per slot ran a chain of dependent loads (nsp, then
// si/sj, then a shared-memory staging loop that divided by a runtime NB),
// a __syncthreads and one 4-byte store a thread, in 23-31 waves of blocks.
//
// The design keeps every slot in flight in about one wave and writes wide:
// - a persistent grid (sized by the occupancy API) of warps, one slot per
//   warp at a time, taken by grid stride over sp_cap;
// - a lane owns 4 consecutive columns j of one row and stores them as one
//   int4: 8 lanes cover a row, so a warp writes 4 rows (512 contiguous
//   bytes) a store and a slot in 8 stores;
// - the lane's 4 b-columns (6 x 4 values) are loaded once a slot, as
//   float4s (double2 pairs in double) where Tb and the pointer allow, else
//   by scalar loads that test the ragged edge; each row's a-tile bounds
//   come straight from `sub` ((6, Ta, NB) is contiguous in NB) as 6 * NB / 4
//   such loads: no shared memory, no __syncthreads;
// - NB is a template parameter (4, 8, 16): no runtime division;
// - a dead slot costs 8 int4 stores a lane and nothing else;
// - two rows in flight a warp (unroll 2) and at most 85 registers a thread
//   in float, so 24 warps fit an SM: at the 1M self scene's inputs on the
//   H100 this beat one row or all 8 rows in flight, a 64-register cap
//   (which spills at NB 8 and 16) and blocks of 128 threads.  Double
//   values take two registers each: 16 warps an SM, 128 registers.
// The comparisons are those of the plain version, so the words are equal
// bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SS = 32;                  // tiles per supertile
constexpr int THREADS = 256;            // warps of a block, one slot each
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;                 // columns of a lane: one int4
constexpr int ROW_LANES = SS / COLS;    // lanes of a row
constexpr int ROWS = 32 / ROW_LANES;    // rows of one warp-wide store
constexpr int STORES = SS / ROWS;       // stores of a slot

template <typename T>
__device__ __forceinline__ bool overlap(const T* a, const T* b) {
  // a: the band's (lo0, lo1, lo2, up0, up1, up2); b: the column's
  return (a[3] >= b[0]) & (a[0] <= b[3]) & (a[4] >= b[1]) & (a[1] <= b[4]) &
         (a[5] >= b[2]) & (a[2] <= b[5]);
}

// Four consecutive values from a 16-byte aligned address: one float4, or
// two double2.
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* src, double (&v)[4]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(src));
  const double2 y = __ldg(reinterpret_cast<const double2*>(src) + 1);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// blocks an SM: at most 85 registers a thread in float, 128 in double
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 3 : 2)
    band_bits_kernel(const T* __restrict__ sub, const T* __restrict__ tiles,
                     const int* __restrict__ si, const int* __restrict__ sj,
                     const int* __restrict__ nsp, int* __restrict__ out,
                     int sp_cap, int Ta, int Tb, int triangle) {
  const int lane = threadIdx.x & 31;
  const int c0 = (lane % ROW_LANES) * COLS;  // the lane's first column
  const int r0 = lane / ROW_LANES;           // its first row
  const int live = __ldg(nsp);
  const bool vec_a = ((uintptr_t)sub & 15) == 0;
  const bool vec_b = Tb % 4 == 0 && ((uintptr_t)tiles & 15) == 0;
  const size_t st = (size_t)Ta * NB;         // stride of a bound in sub
  const int warps = gridDim.x * WARPS;
  for (int p = blockIdx.x * WARPS + threadIdx.x / 32; p < sp_cap;
       p += warps) {
    int4* o = reinterpret_cast<int4*>(out + (size_t)p * SS * SS +
                                      r0 * SS + c0);
    if (p >= live) {
#pragma unroll
      for (int k = 0; k < STORES; ++k)
        o[k * ROWS * SS / COLS] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int ta0 = __ldg(si + p) * SS;
    const int tj0 = __ldg(sj + p) * SS + c0;
    T b[COLS][6];  // the lane's columns: (lo0, lo1, lo2, up0, up1, up2)
    if (vec_b && tj0 + COLS <= Tb) {
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        T v[4];
        load4(tiles + (size_t)f * Tb + tj0, v);
#pragma unroll
        for (int j = 0; j < COLS; ++j) b[j][f] = v[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
#pragma unroll
        for (int f = 0; f < 6; ++f)
          b[j][f] = tj0 + j < Tb ? __ldg(tiles + (size_t)f * Tb + tj0 + j)
                                 : T(0);
    }
#pragma unroll 2
    for (int k = 0; k < STORES; ++k) {
      const int tii = ta0 + r0 + k * ROWS;
      int bits[COLS] = {0, 0, 0, 0};
      if (tii < Ta) {
        const T* a_row = sub + (size_t)tii * NB;
#pragma unroll
        for (int g = 0; g < NB; g += 4) {
          T a[4][6];  // bands g..g+3 of the row
#pragma unroll
          for (int f = 0; f < 6; ++f) {
            const T* src = a_row + f * st + g;
            T v[4];
            if (vec_a) {
              load4(src, v);
            } else {
#pragma unroll
              for (int r = 0; r < 4; ++r) v[r] = __ldg(src + r);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r][f] = v[r];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < COLS; ++j)
              bits[j] |= (int)overlap(a[r], b[j]) << (g + r);
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int tjj = tj0 + j;
          if (tjj >= Tb || (triangle && tii > tjj)) bits[j] = 0;
        }
      }
      o[k * ROWS * SS / COLS] = make_int4(bits[0], bits[1], bits[2], bits[3]);
    }
  }
}

template <typename T, int NB>
void launch_nb(const void* sub, const void* tiles, const void* si,
               const void* sj, const void* nsp, void* out, int sp_cap,
               int Ta, int Tb, int triangle, cudaStream_t stream) {
  auto kern = band_bits_kernel<T, NB>;
  const int blocks = ibvh::persistent_blocks(
      kern, THREADS, 0, ((long long)sp_cap + WARPS - 1) / WARPS);
  kern<<<blocks, THREADS, 0, stream>>>(
      (const T*)sub, (const T*)tiles, (const int*)si, (const int*)sj,
      (const int*)nsp, (int*)out, sp_cap, Ta, Tb, triangle);
}

}  // namespace

// sub: (6, Ta, NB) sub-band bounds (lo0, lo1, lo2, up0, up1, up2), NB in
// {4, 8, 16}; tiles: (6, Tb) tile bounds; both float (value_bits 32) or
// double (64); si, sj: (sp_cap,) i32; nsp: (1,) i32; out: (sp_cap, 32, 32)
// i32, 16-byte aligned.  Returns cudaGetLastError().
extern "C" int band_bits_launch(const void* sub, const void* tiles,
                                const void* si, const void* sj,
                                const void* nsp, void* out, int sp_cap,
                                int Ta, int Tb, int NB, int triangle,
                                int value_bits, void* stream) {
  if ((NB != 4 && NB != 8 && NB != 16) || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (sp_cap > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    IBVH_DISPATCH_VALUE(value_bits, {
      if (NB == 4)
        launch_nb<T, 4>(sub, tiles, si, sj, nsp, out, sp_cap, Ta, Tb,
                        triangle, s);
      else if (NB == 8)
        launch_nb<T, 8>(sub, tiles, si, sj, nsp, out, sp_cap, Ta, Tb,
                        triangle, s);
      else
        launch_nb<T, 16>(sub, tiles, si, sj, nsp, out, sp_cap, Ta, Tb,
                         triangle, s);
    })
  }
  return (int)cudaGetLastError();
}
