// T1: the BVH build of BSphere or BBox leaves into BBox nodes, around one
// library sort.
//
// Replaces no TPU kernel.  The JAX package builds in XLA ops
// (implicitbvh_tpu/build.py: the Morton codes, jnp.argsort, the per-level
// pairwise min/max), and the port's plain version (ops/tree_build.py:
// tree_build_plain) is the same chain in about 175 torch ops at 2^20
// leaves.  These kernels give the chain's outputs bit for bit.
//
// The chain, and what each launch does of it:
// - T1a (extrema_kernel): the leaves' centres (x for spheres, 0.5 * (lo +
//   up) for boxes), and per block the three minima and maxima, NaN
//   propagating as torch.amin / amax propagate it, into a scratch of
//   partials.  Launched only when the extrema are computed.
// - T1b (codes_kernel): every block reduces the partials (at most
//   MAX_PARTIALS of them) and applies m - rp * |m| - tiny and M + rp * |M| +
//   tiny, each operation rounded on its own as the torch chain rounds it;
//   fixed bounds come in by value instead.  Then per leaf: the quantized
//   coordinate (c - mn) / (mx - mn) * scaling, truncated by the card's
//   float -> int64 conversion; the magic-mask interleave (morton_split3);
//   the key, int32 for the 16- and 32-bit orders (codes of 15 and 30 bits)
//   and int64 for the 64-bit order (63 bits).  A default code is never
//   negative, so the key's signed order is the code's order.  It also
//   packs the leaf's fields into one record of 16 or 32 bytes (float), so
//   that T1c's gather through the permutation reads one or two sectors a
//   leaf, not one a field: the gather dominated T1c.  Reducing the
//   partials in every block leaves no counter to reset between builds, so a
//   captured build replays, and builds on two streams share nothing.
// - torch.sort(keys, stable=True) in the caller: the one library call, as
//   jnp.argsort stays XLA's in the JAX package.  Stable, so equal codes
//   keep their order and the leaves' order is the plain version's.
// - T1c (leaves_kernel): a block takes 2^K consecutive sorted slots.  Per
//   slot it gathers the leaf's record through the permutation, writes the
//   sorted leaf, its index (perm + 1 without user indices) and its code
//   widened to int64, forms the leaf box (x - r, x + r), or the padding
//   +-max past the real leaves, and then the block reduces K levels
//   pairwise in shared memory, writing each level's real nodes at their
//   memory-index offsets.  The grid also zero-fills the levels above
//   built_level.
// - T1d (top_kernel): one block of 1,024 threads reduces the levels above
//   the block roots, a level at a time (a virtual child is the padding):
//   from the nodes written below while a level has more than 1,024
//   children, then in shared memory.  It also writes the skip table from
//   the tree's integers.  It loops over a level's nodes, so any number of
//   roots works.
// A node is min / max of its children as amin / amax reduce a pair: the
// left child unless the right one is smaller (larger), a NaN left child
// kept, a NaN right one taken; explicit compares, never fminf / fmaxf.
// Every launch goes on the caller's stream; nothing is allocated and
// nothing read back, so a CUDA graph captures the build.
//
// Bound on the H100: bytes.  At 2^20 sphere leaves the build reads the
// centres (T1a) and the leaves (T1b), writes the keys and the records,
// reads the sorted keys, the permutation and the records (gathered, a
// 32-byte sector each) and writes the sorted leaves, their indices and
// codes and the nodes: about 130 MB, 0.04 ms at 3.35 TB/s, besides the
// sort.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <type_traits>

#include "common.cuh"

namespace {

using ibvh::add_rn;
using ibvh::div_rn;
using ibvh::mul_rn;
using ibvh::sub_rn;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TOP_THREADS = 1024;
constexpr int MAX_PARTIALS = 512;
constexpr int MAX_LEVELS = 48;
constexpr int CODE_ITEMS = 4;
constexpr unsigned FULL = 0xffffffffu;

// The leaves' fields: x0, x1, x2, r for spheres; lo0, lo1, lo2, up0, up1,
// up2 for boxes; each a base pointer and an element stride.
struct Fields {
  const void* p[6];
  long long stride[6];
};

// Per level l (1-based): its real nodes and their offset in memory-index
// order (level 1 first).
struct Levels {
  long long count[MAX_LEVELS];
  long long offset[MAX_LEVELS];
};

template <typename T>
__device__ __forceinline__ T big();
template <>
__device__ __forceinline__ float big<float>() {
  return FLT_MAX;
}
template <>
__device__ __forceinline__ double big<double>() {
  return DBL_MAX;
}

// torch.amin / amax of the pair (a, b), a first
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T field(const Fields& f, int q, long long i) {
  return static_cast<const T*>(f.p[q])[i * f.stride[q]];
}

template <typename T, bool BOX>
__device__ __forceinline__ void centre(const Fields& f, long long i, T* c) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = BOX ? mul_rn(T(0.5), add_rn(field<T>(f, k, i),
                                       field<T>(f, 3 + k, i)))
               : field<T>(f, k, i);
}

// A leaf's fields packed into one record of whole 16-byte vectors: 4
// values for a sphere, 8 for a box (the last two unused); 16 or 32 bytes
// of float, 32 or 64 of double, so one or two sectors a leaf.
template <typename T, bool BOX>
struct Record {
  static constexpr int F = BOX ? 6 : 4;
  static constexpr int PER = 16 / sizeof(T);     // values a vector
  static constexpr int NV = (BOX ? 8 : 4) / PER;  // vectors a record
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;

  static __device__ __forceinline__ void store(void* rec, long long i,
                                               const T* v) {
    V* dst = static_cast<V*>(rec) + i * NV;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      V x;
      T* xs = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int c = 0; c < PER; ++c)
        xs[c] = k * PER + c < F ? v[k * PER + c] : T(0);
      dst[k] = x;
    }
  }

  static __device__ __forceinline__ void load(const void* rec, long long i,
                                              T* v) {
    const V* src = static_cast<const V*>(rec) + i * NV;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const V x = src[k];
      const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int c = 0; c < PER; ++c)
        if (k * PER + c < F) v[k * PER + c] = xs[c];
    }
  }
};

// Six running extrema (three minima, then three maxima) reduced over the
// block; the result is in thread 0.
template <typename T>
__device__ __forceinline__ void block_extrema(T* v, T (*sh)[6]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const T w = __shfl_down_sync(FULL, v[q], o);
      v[q] = q < 3 ? min_nan(v[q], w) : max_nan(v[q], w);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 6; ++q) sh[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w)
#pragma unroll
      for (int q = 0; q < 6; ++q)
        v[q] = q < 3 ? min_nan(v[q], sh[w][q]) : max_nan(v[q], sh[w][q]);
}

template <typename T>
__device__ __forceinline__ void init_extrema(T* v) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = T(INFINITY);
    v[3 + q] = -T(INFINITY);
  }
}

// T1a: block b's extrema of the centres into partials[q * G + b].
template <typename T, bool BOX>
__global__ void __launch_bounds__(THREADS)
    extrema_kernel(Fields f, long long n, T* __restrict__ partials) {
  __shared__ T sh[WARPS][6];
  T v[6];
  init_extrema(v);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    T c[3];
    centre<T, BOX>(f, i, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = min_nan(v[k], c[k]);
      v[3 + k] = max_nan(v[3 + k], c[k]);
    }
  }
  block_extrema(v, sh);
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < 6; ++q) partials[q * gridDim.x + blockIdx.x] = v[q];
}

// morton_split3: the low bits of v spread two apart (the magic masks of
// morton.py:_SPLIT3); unsigned, so the shifts wrap as torch's int64 shifts
// do, and the masks keep the same bits.
template <int BITS>
__device__ __forceinline__ unsigned long long split3(long long v) {
  unsigned long long s = (unsigned long long)v;
  if (BITS == 16) {
    s &= 0x001Full;
    s = (s | (s << 8)) & 0x100Full;
    s = (s | (s << 4)) & 0x10C3ull;
    s = (s | (s << 2)) & 0x1249ull;
  } else if (BITS == 32) {
    s &= 0x03FFull;
    s = (s | (s << 16)) & 0x30000FFull;
    s = (s | (s << 8)) & 0x0300F00Full;
    s = (s | (s << 4)) & 0x30C30C3ull;
    s = (s | (s << 2)) & 0x9249249ull;
  } else {
    s &= 0x1FFFFFull;
    s = (s | (s << 32)) & 0x1F00000000FFFFull;
    s = (s | (s << 16)) & 0x1F0000FF0000FFull;
    s = (s | (s << 8)) & 0x100F00F00F00F00Full;
    s = (s | (s << 4)) & 0x10C30C30C30C30C3ull;
    s = (s | (s << 2)) & 0x1249249249249249ull;
  }
  return s;
}

template <int BITS>
struct Scaling;
template <>
struct Scaling<16> {
  static constexpr int value = 1 << 5;
};
template <>
struct Scaling<32> {
  static constexpr int value = 1 << 10;
};
template <>
struct Scaling<64> {
  static constexpr int value = 1 << 21;
};

// T1b: the bounds (reduced from T1a's partials, or given), then every
// leaf's key.
template <typename T, bool BOX, int BITS, typename Key>
__global__ void __launch_bounds__(THREADS)
    codes_kernel(Fields f, long long n, const T* __restrict__ partials,
                 int n_partials, T rp, T b0, T b1, T b2, T b3, T b4, T b5,
                 Key* __restrict__ keys, void* __restrict__ records) {
  using Rec = Record<T, BOX>;
  __shared__ T sh[WARPS][6];
  __shared__ T bounds[6];
  if (n_partials > 0) {
    T v[6];
    init_extrema(v);
    for (int j = threadIdx.x; j < n_partials; j += THREADS)
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const T w = partials[q * n_partials + j];
        v[q] = q < 3 ? min_nan(v[q], w) : max_nan(v[q], w);
      }
    block_extrema(v, sh);
    if (threadIdx.x == 0) {
      const T tiny = sizeof(T) == 4 ? T(FLT_MIN) : T(DBL_MIN);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T m = v[k], M = v[3 + k];
        bounds[k] = sub_rn(sub_rn(m, mul_rn(rp, fabs(m))), tiny);
        bounds[3 + k] = add_rn(add_rn(M, mul_rn(rp, fabs(M))), tiny);
      }
    }
  } else if (threadIdx.x == 0) {
    bounds[0] = b0;
    bounds[1] = b1;
    bounds[2] = b2;
    bounds[3] = b3;
    bounds[4] = b4;
    bounds[5] = b5;
  }
  __syncthreads();
  T mn[3], den[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mn[k] = bounds[k];
    den[k] = sub_rn(bounds[3 + k], bounds[k]);
  }
  const T scaling = T(Scaling<BITS>::value);
  // CODE_ITEMS leaves a thread a pass, all loaded before any key is
  // stored, so that their loads are in flight together
  const long long chunk = (long long)THREADS * CODE_ITEMS;
  for (long long c0 = blockIdx.x * chunk; c0 < n;
       c0 += (long long)gridDim.x * chunk) {
    T v[CODE_ITEMS][Rec::F];
#pragma unroll
    for (int u = 0; u < CODE_ITEMS; ++u) {
      const long long i = c0 + u * THREADS + threadIdx.x;
      if (i < n)
#pragma unroll
        for (int q = 0; q < Rec::F; ++q) v[u][q] = field<T>(f, q, i);
    }
#pragma unroll
    for (int u = 0; u < CODE_ITEMS; ++u) {
      const long long i = c0 + u * THREADS + threadIdx.x;
      if (i >= n) break;
      unsigned long long s[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        // the centre as center_coords gives it
        const T c = BOX ? mul_rn(T(0.5), add_rn(v[u][k], v[u][3 + k]))
                        : v[u][k];
        const T scaled = mul_rn(div_rn(sub_rn(c, mn[k]), den[k]), scaling);
        s[k] = split3<BITS>((long long)scaled);
      }
      keys[i] = (Key)((s[0] << 2) | (s[1] << 1) | s[2]);
      Rec::store(records, i, v[u]);
    }
  }
}

// The slots a T1c block holds in shared memory: 2^10 floats or 2^9
// doubles of each of the six box fields, 24 KB.
template <typename T>
struct Tile {
  static constexpr int value = sizeof(T) == 4 ? 1024 : 512;
};

// T1c: block b takes sorted slots [b * 2^K, (b + 1) * 2^K): the sorted
// leaves, indices and codes of its real slots, and its K levels of nodes.
// out_vol holds F rows of n; nodes 6 rows (lo0..2, up0..2) of n_nodes.
template <typename T, bool BOX, typename Index, typename Key>
__global__ void __launch_bounds__(THREADS)
    leaves_kernel(const void* __restrict__ records, long long n,
                  const Key* __restrict__ sorted,
                  const long long* __restrict__ perm,
                  const Index* __restrict__ user_index, long long user_stride,
                  T* __restrict__ out_vol, Index* __restrict__ out_index,
                  long long* __restrict__ out_code, T* __restrict__ nodes,
                  long long n_nodes, Levels lv, int levels, int K, int built,
                  long long zero_end) {
  constexpr int F = BOX ? 6 : 4;
  constexpr int TILE = Tile<T>::value;
  constexpr int PER = TILE / 2 / THREADS;    // nodes a thread, first level
  __shared__ T box[6][TILE];
  const int S = 1 << K;
  const long long base = (long long)blockIdx.x * S;

  // the levels above built_level are zeros, the grid's share each
  const long long zstride = (long long)gridDim.x * THREADS;
  for (long long z = (long long)blockIdx.x * THREADS + threadIdx.x;
       z < zero_end; z += zstride)
#pragma unroll
    for (int q = 0; q < 6; ++q) nodes[q * n_nodes + z] = T(0);

  // slot j = threadIdx.x + a * THREADS of the block; every load (the
  // permutation, then the gathered fields) is issued before any store, so
  // that a thread's loads are in flight together
  constexpr int ITEMS = TILE / THREADS;
  long long p[ITEMS];
#pragma unroll
  for (int a = 0; a < ITEMS; ++a) {
    const int j = threadIdx.x + a * THREADS;
    p[a] = j < S && base + j < n ? perm[base + j] : -1;
  }
  T v[ITEMS][F];
#pragma unroll
  for (int a = 0; a < ITEMS; ++a)
    if (p[a] >= 0) Record<T, BOX>::load(records, p[a], v[a]);
#pragma unroll
  for (int a = 0; a < ITEMS; ++a) {
    const int j = threadIdx.x + a * THREADS;
    if (j >= S) break;
    const long long s = base + j;
    T lo[3], up[3];
    if (p[a] >= 0) {
#pragma unroll
      for (int q = 0; q < F; ++q) out_vol[q * n + s] = v[a][q];
      out_index[s] = user_index ? user_index[p[a] * user_stride]
                                : (Index)(p[a] + 1);
      out_code[s] = (long long)sorted[s];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = BOX ? v[a][k] : sub_rn(v[a][k], v[a][3]);
        up[k] = BOX ? v[a][3 + k] : add_rn(v[a][k], v[a][3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = big<T>();
        up[k] = -big<T>();
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box[k][j] = lo[k];
      box[3 + k][j] = up[k];
    }
  }
  __syncthreads();

  for (int d = 1; d <= K; ++d) {
    const int m = S >> d;
    const int l = levels - d;
    T r[PER > 0 ? PER : 1][6];
#pragma unroll
    for (int a = 0; a < (PER > 0 ? PER : 1); ++a) {
      const int i = threadIdx.x + a * THREADS;
      if (i < m)
#pragma unroll
        for (int q = 0; q < 6; ++q)
          r[a][q] = q < 3 ? min_nan(box[q][2 * i], box[q][2 * i + 1])
                          : max_nan(box[q][2 * i], box[q][2 * i + 1]);
    }
    __syncthreads();
    const bool write = l >= built;
    const long long count = lv.count[l], offset = lv.offset[l];
#pragma unroll
    for (int a = 0; a < (PER > 0 ? PER : 1); ++a) {
      const int i = threadIdx.x + a * THREADS;
      if (i < m) {
        const long long g = (long long)blockIdx.x * m + i;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          box[q][i] = r[a][q];
          if (write && g < count) nodes[q * n_nodes + offset + g] = r[a][q];
        }
      }
    }
    __syncthreads();
  }
}

// T1d: levels top .. built (one block), and the skip table: skips[l - 1]
// = 2 v - popcount(v), v = virtual_leaves >> (levels + 1 - l).  A level
// whose children number more than TOP_THREADS reads them from the nodes
// written below it; from the first level whose children fit, they are
// loaded once into shared memory and the levels above reduce there.
template <typename T, typename Index>
__global__ void __launch_bounds__(TOP_THREADS)
    top_kernel(T* __restrict__ nodes, long long n_nodes, Levels lv,
               int levels, int top, int built, long long virtual_leaves,
               Index* __restrict__ skips) {
  __shared__ T sh[6][TOP_THREADS];   // 24 KB of floats, 48 KB of doubles
  int l = top;
  for (; l >= built && lv.count[l + 1] > TOP_THREADS; --l) {
    const long long m = lv.count[l], below = lv.count[l + 1];
    const long long at = lv.offset[l], from = lv.offset[l + 1];
    for (long long i = threadIdx.x; i < m; i += TOP_THREADS) {
      const long long a = from + 2 * i;
      const bool right = 2 * i + 1 < below;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const T* row = nodes + q * n_nodes;
        const T pad = q < 3 ? big<T>() : -big<T>();
        const T x = row[a], y = right ? row[a + 1] : pad;
        nodes[q * n_nodes + at + i] = q < 3 ? min_nan(x, y) : max_nan(x, y);
      }
    }
    __syncthreads();
  }
  if (l >= built) {
    int below = (int)lv.count[l + 1];
    const long long from = lv.offset[l + 1];
    for (int t = threadIdx.x; t < below; t += TOP_THREADS)
#pragma unroll
      for (int q = 0; q < 6; ++q) sh[q][t] = nodes[q * n_nodes + from + t];
    __syncthreads();
    for (; l >= built; --l) {
      const int m = (int)lv.count[l], i = threadIdx.x;
      T r[6];
      if (i < m)
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const T pad = q < 3 ? big<T>() : -big<T>();
          const T x = sh[q][2 * i], y = 2 * i + 1 < below ? sh[q][2 * i + 1]
                                                          : pad;
          r[q] = q < 3 ? min_nan(x, y) : max_nan(x, y);
        }
      __syncthreads();
      if (i < m)
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          sh[q][i] = r[q];
          nodes[q * n_nodes + lv.offset[l] + i] = r[q];
        }
      __syncthreads();
      below = m;
    }
  }
  for (int k = threadIdx.x + 1; k <= levels; k += TOP_THREADS) {
    const long long v = virtual_leaves >> (levels + 1 - k);
    skips[k - 1] = (Index)(2 * v - __popcll((unsigned long long)v));
  }
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// What T1a and T1b take (see tree_codes_launch).
struct CodesArgs {
  Fields f;
  long long n;
  int compute, n_partials;
  const double* bounds;
  double rp;
  void *partials, *keys, *records;
};

template <typename T, bool BOX, int BITS, typename Key>
void launch_codes(const CodesArgs& a, cudaStream_t stream) {
  if (a.compute)
    extrema_kernel<T, BOX><<<a.n_partials, THREADS, 0, stream>>>(
        a.f, a.n, (T*)a.partials);
  const long long want = (a.n + THREADS * CODE_ITEMS - 1) /
                         (THREADS * CODE_ITEMS);
  const int grid = (int)std::min(want, 4LL * sm_count());
  const double* b = a.bounds;
  codes_kernel<T, BOX, BITS, Key><<<grid, THREADS, 0, stream>>>(
      a.f, a.n, (const T*)a.partials, a.compute ? a.n_partials : 0, (T)a.rp,
      (T)b[0], (T)b[1], (T)b[2], (T)b[3], (T)b[4], (T)b[5], (Key*)a.keys,
      a.records);
}

template <typename T, bool BOX>
void codes_by_bits(int bits, const CodesArgs& a, cudaStream_t s) {
  if (bits == 16)
    launch_codes<T, BOX, 16, int>(a, s);
  else if (bits == 32)
    launch_codes<T, BOX, 32, int>(a, s);
  else
    launch_codes<T, BOX, 64, long long>(a, s);
}

// What T1c and T1d take (see tree_nodes_launch).
struct NodesArgs {
  const void *records, *sorted, *perm, *user_index;
  long long n, user_stride, n_nodes, zero_end, virtual_leaves;
  void *out_vol, *out_index, *out_code, *nodes, *skips;
  int levels, K, built;
};

template <typename T, bool BOX, typename Index, typename Key>
void launch_nodes(const NodesArgs& a, const Levels& lv, cudaStream_t stream) {
  const long long blocks = (a.n + (1LL << a.K) - 1) >> a.K;
  leaves_kernel<T, BOX, Index, Key><<<(int)blocks, THREADS, 0, stream>>>(
      a.records, a.n, (const Key*)a.sorted, (const long long*)a.perm,
      (const Index*)a.user_index, a.user_stride, (T*)a.out_vol,
      (Index*)a.out_index, (long long*)a.out_code, (T*)a.nodes, a.n_nodes,
      lv, a.levels, a.K, a.built, a.zero_end);
  top_kernel<T, Index><<<1, TOP_THREADS, 0, stream>>>(
      (T*)a.nodes, a.n_nodes, lv, a.levels, a.levels - a.K - 1, a.built,
      a.virtual_leaves, (Index*)a.skips);
}

template <typename T, bool BOX>
void nodes_by_types(int wide_index, int wide_key, const NodesArgs& a,
                    const Levels& lv, cudaStream_t s) {
  if (wide_index) {
    if (wide_key) launch_nodes<T, BOX, long long, long long>(a, lv, s);
    else launch_nodes<T, BOX, long long, int>(a, lv, s);
  } else {
    if (wide_key) launch_nodes<T, BOX, int, long long>(a, lv, s);
    else launch_nodes<T, BOX, int, int>(a, lv, s);
  }
}

}  // namespace

// T1a and T1b.  fields: 4 (spheres) or 6 (boxes) pointers with element
// strides, float (f64 0) or double (f64 1); n leaves, 1 <= n < 2^31; bits
// 16, 32 or 64; compute 1: the extrema from the centres, through
// n_partials (1 to 512) partials of 6 values in partials; compute 0: the
// bounds (mn0, mn1, mn2, mx0, mx1, mx2) as given, rounded to the value
// type.  rp: the relative precision.  keys: n int32 (bits 16, 32) or int64
// (bits 64).  records: 16-byte aligned, n records of 4 (spheres) or 8
// (boxes) values, each leaf's fields for T1c.  One or two launches on the
// stream; returns cudaGetLastError().
extern "C" int tree_codes_launch(const void* const* fields,
                                 const long long* strides, int box, int f64,
                                 long long n, int bits, int compute,
                                 int n_partials, const double* bounds,
                                 double rp, void* partials, void* keys,
                                 void* records, void* stream) {
  if (n < 1 || n >= (1LL << 31) || (bits != 16 && bits != 32 && bits != 64) ||
      (compute && (n_partials < 1 || n_partials > MAX_PARTIALS)) ||
      ((size_t)records & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CodesArgs a{};
  for (int q = 0; q < (box ? 6 : 4); ++q) {
    a.f.p[q] = fields[q];
    a.f.stride[q] = strides[q];
  }
  a.n = n;
  a.compute = compute;
  a.n_partials = n_partials;
  a.bounds = bounds;
  a.rp = rp;
  a.partials = partials;
  a.keys = keys;
  a.records = records;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    if (box) codes_by_bits<double, true>(bits, a, s);
    else codes_by_bits<double, false>(bits, a, s);
  } else {
    if (box) codes_by_bits<float, true>(bits, a, s);
    else codes_by_bits<float, false>(bits, a, s);
  }
  return (int)cudaGetLastError();
}

// T1c and T1d.  records: T1b's; sorted: the n sorted keys (int64 where
// wide_key, else int32); perm: n int64; user_index: n indices at
// user_stride, or null (then perm + 1); index_bytes 4 or 8 for out_index
// and skips; out_vol: 4 or 6 rows of n values; out_code: n int64; nodes: 6
// rows of n_nodes values; counts and offsets: per level 1 .. levels - 1, at
// [l]; K: the levels a T1c block reduces, 0 <= K <= levels - 1 and 2^K <=
// 1024 (float) or 512 (double); built: the built level; zero_end: the
// offset of level built; skips: levels entries.  Two launches on the
// stream; returns cudaGetLastError().
extern "C" int tree_nodes_launch(
    const void* records, int box, int f64, long long n, int wide_key,
    const void* sorted, const void* perm, const void* user_index,
    long long user_stride, int index_bytes, void* out_vol, void* out_index,
    void* out_code, void* nodes, long long n_nodes, const long long* counts,
    const long long* offsets, int levels, int K, int built,
    long long zero_end, long long virtual_leaves, void* skips, void* stream) {
  const int tile = f64 ? Tile<double>::value : Tile<float>::value;
  if (n < 1 || n >= (1LL << 31) || levels < 1 || levels > MAX_LEVELS - 1 ||
      K < 0 || K > levels - 1 || (1 << K) > tile || built < 1 ||
      built > levels || (index_bytes != 4 && index_bytes != 8) ||
      ((size_t)records & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 1; l < levels; ++l) {
    lv.count[l] = counts[l];
    lv.offset[l] = offsets[l];
  }
  const NodesArgs a{records, sorted, perm, user_index, n, user_stride,
                    n_nodes, zero_end, virtual_leaves, out_vol, out_index,
                    out_code, nodes, skips, levels, K, built};
  cudaStream_t s = (cudaStream_t)stream;
  const int wide_index = index_bytes == 8;
  if (f64) {
    if (box) nodes_by_types<double, true>(wide_index, wide_key, a, lv, s);
    else nodes_by_types<double, false>(wide_index, wide_key, a, lv, s);
  } else {
    if (box) nodes_by_types<float, true>(wide_index, wide_key, a, lv, s);
    else nodes_by_types<float, false>(wide_index, wide_key, a, lv, s);
  }
  return (int)cudaGetLastError();
}
