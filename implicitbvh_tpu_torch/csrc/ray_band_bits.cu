// R1: phase 1 of the tile ray query, the (ray tile, leaf tile) band bits.
//
// Replaces no Pallas kernel: the JAX package computes this in jnp under
// lax.map (implicitbvh_tpu/traverse/ray_tiles.py:_ray_tile_hits), which XLA
// fuses; the port's torch-op version (ops/subtile.py:ray_band_bits_plain)
// materialises each chunk of tests in device memory.  out[rt, t] is an
// NB-bit word whose bit r is set iff a ray of sub-band r (rays
// r*G/NB .. (r+1)*G/NB - 1) of ray tile rt hits the AABB of leaf tile t, by
// the slab test of common.cuh:ray_box_hit (explicitly rounded, select
// min/max, 1/d an IEEE division): the plain version's operations in the
// same order, so the words are equal bit for bit, NaN-padded rays and
// zero direction components included.
//
// Bound on the H100: the instruction rate.  Every ray is tested against
// every leaf tile, RT*G*T tests (195M at 100,000 rays against the
// 249,882-leaf scene at G 128: RT 782, T 1,953).  A test is 35 instructions
// in float: per axis two subtractions, two multiplications and the select
// minimum and maximum (a compare and a select each), on the second and
// third axes two more select pairs to fold tmin and tmax, then two compares
// and the fold into the band's flag; no FMA (-fmad=false).  At the card's
// non-FMA fp32 rate (33.5e12 a second) that is 0.2 ms.  The bytes are the
// rays (24 bytes each), the tile bounds and the (RT, T) int32 words: 8.5 MB
// there, 0.003 ms.
//
// Design: a block takes one ray tile against a chunk of TILES leaf tiles.
// - The block first prepares the tile's G rays (1/d by IEEE division, once
//   a ray) as two 16-byte records each in shared memory, the records of
//   B2-B4 (common.cuh:Rec): every test then reads its ray with one
//   broadcast 128-bit load a record, all lanes on the same address.
// - A thread owns K leaf tiles (t, t + THREADS, ...) whose bounds stay in
//   registers, so one ray's records feed K tests; the loop over the rays is
//   a loop over the NB bands, each band's flags folded with |= and shifted
//   into the word once a band.  No lane ever waits for another: there is
//   no reduction across lanes or warps, because a word belongs to one
//   thread, and any (G, NB) with NB | G takes the same loop.
// - Lanes of a warp own consecutive tiles, so the tile bounds are read and
//   the words written in coalesced 128-byte rows.  Nothing is allocated,
//   nothing syncs with the host, and every word of the output is written.
// - The grid is (RT * chunks) blocks of 128 threads, a ray tile's chunks
//   adjacent; at the dragon shape 6,256 blocks of 4 KB of shared memory,
//   16 blocks an SM.
// Double values take two registers and half the rate; the records are 32
// bytes, 64 KB at G 1024 (opted in above 48 KB).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;        // threads of a block
constexpr int K = 2;                // leaf tiles of a thread
constexpr int TILES = THREADS * K;  // leaf tiles of a block
constexpr int RA = ibvh::Rec<ibvh::RAY_BOX>::RA;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ray_band_bits_kernel(const T* __restrict__ rfields,
                         const T* __restrict__ tiles, int* __restrict__ out,
                         int RT, int G, int Tn, int NB, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* rays = reinterpret_cast<ibvh::rec_t<T>*>(smem);
  const int rt = blockIdx.x / chunks;
  const int t0 = (blockIdx.x % chunks) * TILES + threadIdx.x;
  for (int i = threadIdx.x; i < G; i += THREADS) {
    T a[4 * RA];
    ibvh::load_a_rec<ibvh::RAY_BOX>(rfields, RT, G, rt, i, a);
    ibvh::store_rec<RA>(rays, i, a);
  }
  T b[K][6];  // the thread's tiles: (lo0, lo1, lo2, up0, up1, up2)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = min(t0 + k * THREADS, Tn - 1);
#pragma unroll
    for (int f = 0; f < 6; ++f) b[k][f] = __ldg(tiles + (size_t)f * Tn + t);
  }
  __syncthreads();
  const int BH = G / NB;
  int bits[K] = {};
#pragma unroll 1
  for (int r = 0; r < NB; ++r) {
    bool any[K] = {};
#pragma unroll 4
    for (int i = r * BH; i < (r + 1) * BH; ++i) {
      T a[4 * RA];
      ibvh::load_rec<RA>(rays, i, a);
#pragma unroll
      for (int k = 0; k < K; ++k) any[k] |= ibvh::ray_box_hit(a, b[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) bits[k] |= (int)any[k] << r;
  }
  int* row = out + (size_t)rt * Tn;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k * THREADS;
    if (t < Tn) row[t] = bits[k];
  }
}

template <typename T>
int launch(const void* rfields, const void* tiles, void* out, int RT, int G,
           int Tn, int NB, cudaStream_t stream) {
  auto kern = ray_band_bits_kernel<T>;
  const size_t shmem = (size_t)G * RA * sizeof(ibvh::rec_t<T>);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int chunks = (Tn + TILES - 1) / TILES;
  kern<<<(unsigned)((long long)RT * chunks), THREADS, shmem, stream>>>(
      (const T*)rfields, (const T*)tiles, (int*)out, RT, G, Tn, NB, chunks);
  return 0;
}

}  // namespace

// rfields: (6, RT, G) rays (p0, p1, p2, d0, d1, d2), NaN-padded; tiles:
// (6, T) leaf-tile bounds (lo0, lo1, lo2, up0, up1, up2); both float
// (value_bits 32) or double (64).  G a multiple of 32 up to 1024, NB in
// {4, 8, 16}, RT * ceil(T / 256) below 2^31.  out: (RT, T) i32.  Returns
// cudaGetLastError().
extern "C" int ray_band_bits_launch(const void* rfields, const void* tiles,
                                    void* out, int RT, int G, int Tn, int NB,
                                    int value_bits, void* stream) {
  if ((NB != 4 && NB != 8 && NB != 16) || G % 32 != 0 || G < 32 ||
      G > 1024)
    return (int)cudaErrorInvalidValue;
  if (RT > 0 && Tn > 0) {
    int err = 0;
    IBVH_DISPATCH_VALUE(value_bits, {
      err = launch<T>(rfields, tiles, out, RT, G, Tn, NB,
                      (cudaStream_t)stream);
    })
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
