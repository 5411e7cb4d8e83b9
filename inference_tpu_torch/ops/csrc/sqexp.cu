// Kernel B2: the squared-exponential covariance block, written for Hopper (sm_90a).
//
// Replaces inference_tpu/ops/pairwise.py::_sqexp_pallas, the Pallas kernel
// that pairwise.py::_sqexp_pallas_diff wraps. Its plain PyTorch version is
// inference_tpu_torch/ops/pairwise.py::_sqexp_reference, and the wrapper that
// launches it is _launch_sqexp in the same module, by the plan sqexp_plan.
//
// What it computes. For pre-scaled rows us = u / l (M, D) and vs = v / l
// (N, D), row-major, and a device scalar amp_sq = A^2:
//   out[i, j] = amp_sq * exp(-0.5 * sum_k (us[i, k] - vs[j, k])^2)
// with the sum taken over k in order from exact coordinate differences, never
// from |us|^2 + |vs|^2 - 2 us.vs (which cancels catastrophically in float32).
// Two instantiations, float and double, behind two plain C entry points.
//
// What bounds it on this card. The M x N store: at M = N = 16,384 that is
// 2.15 GB in double (1.07 GB in float), about 0.64 ms (0.32 ms) at 3.35 TB/s.
// Each entry costs 3 D + 1 flops and one exp; in double the exp is a software
// sequence of some twenty FP64 instructions, about 0.4 ms of FP64 issue at
// D = 2, so double reaches the store bound only if that work hides under the
// stores. The reads (M + N) * D values are negligible.
//
// What the design does about it.
// - D is fixed at compile time: one library per D up to pairwise.B2_D_REG
//   (-DB2_D=<D>, built at first use by pairwise.kernel_variant), so every
//   loop over k unrolls with no guards and a thread keeps its columns'
//   coordinates in registers; each row's coordinates are loads that all the
//   threads of a warp share. One wide library (-DB2_D=0) takes any larger D
//   at run time: a thread keeps its entries' partial distances in registers
//   and the tile's coordinates pass through shared memory KC dimensions at a
//   time. A runtime D read by a loop predicated to a largest D pays the
//   largest D's work in every entry: at D = 2 in double, 143 instructions
//   per entry (67 FP64) for a largest D of 16, against 52 (25 FP64) with D
//   fixed. Above D = 5 the per-D library was slower than the wide one on the
//   H100 (PERF.md, B2), hence B2_D_REG = 5.
// - A persistent walk. The grid is the wrapper's plan, MINB blocks per SM on
//   every SM; block b takes the output tiles b, b + grid, ... in row-major
//   tile order, so the blocks running together write neighbouring column
//   ranges of the same rows. A tile is TM rows of 1 KiB (128 doubles or 256
//   floats). The registers are held to MINB blocks per SM
//   (__launch_bounds__): with fewer warps per SM the stores did not keep the
//   memory busy (2 blocks: 1.45x the bound; 4: 1.10x).
// - Full-width stores. 256 threads as 64 across a tile row by 4 down it; a
//   thread owns 16 bytes of a row (2 doubles or 4 floats) and TM / 4 rows, so
//   each warp's store is one 16-byte streaming store a thread (VECTOR), one
//   contiguous 512-byte run. That needs a row pitch of whole 16-byte units;
//   other pitches (odd N in double, N not a multiple of 4 in float) take
//   SCALAR, the same walk with one store per entry. A TMA store of each tile
//   from shared memory, double-buffered, tied the vector stores in double
//   and lost 1-2% in float (PERF.md), so it was not kept.
// Rows past M are not computed; columns past N are computed on the last
// column's coordinates and not stored. Built with --fmad=false and the
// accurate exp/expf (no fast math), so it rounds as the plain version's
// separate torch operations do: bit for bit on the H100.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef B2_D
#error "build with -DB2_D=<D> (pairwise.kernel_variant): the feature dimension, 0 for any"
#endif

namespace {

constexpr int D = B2_D;          // 0: the wide instantiation, D at run time
constexpr int DR = D > 0 ? D : 1;  // register arrays of the per-D instantiation
constexpr int THREADS = 256;
constexpr int ROW_BYTES = 1024;  // a tile row
constexpr int TM = 32;           // tile rows (pairwise.py B2_TILE_M)
constexpr int TX = 64;           // threads across a tile row, 16 bytes each
constexpr int TY = THREADS / TX; // threads down a tile
constexpr int KC = 16;           // dimensions per staged chunk of the wide instantiation
// blocks per SM the registers are held to (64 or 85 registers a thread), as
// pairwise.py::_blocks_per_sm: the walk launches this many
constexpr int MINB = D >= 1 && D <= 4 ? 4 : 3;
enum Route { SCALAR = 0, VECTOR = 1 };  // pairwise.py ROUTES

template <typename T> struct Elem;
template <> struct Elem<double> { using Vec = double2; };
template <> struct Elem<float> { using Vec = float4; };
template <typename T> constexpr int VN = 16 / (int)sizeof(T);         // entries per 16 bytes
template <typename T> constexpr int TN = ROW_BYTES / (int)sizeof(T);  // tile columns

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ double2 as_vec(const double (&v)[2]) { return make_double2(v[0], v[1]); }
__device__ __forceinline__ float4 as_vec(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the walk: the output's shape and the plan's tiles
struct Walk {
  int m, n, d, tiles_n, n_tiles;
};

// one thread's VN entries of one row, past the last row or column stored
// nowhere: one 16-byte store (VECTOR, n a multiple of VN) or one per entry
template <typename T, int ROUTE>
__device__ __forceinline__ void put(T* __restrict__ out, const T (&val)[VN<T>], int row, int c,
                                    const Walk& w) {
  if (row >= w.m) return;
  T* p = out + (size_t)row * w.n + c;
  if constexpr (ROUTE == VECTOR) {
    if (c < w.n) __stcs(reinterpret_cast<typename Elem<T>::Vec*>(p), as_vec(val));
  } else {
#pragma unroll
    for (int v = 0; v < VN<T>; ++v)
      if (c + v < w.n) __stcs(p + v, val[v]);
  }
}

template <typename T, int ROUTE>
__global__ void __launch_bounds__(THREADS, MINB)
sqexp_kernel(const T* __restrict__ us, const T* __restrict__ vs, const T* __restrict__ amp_sq,
             T* __restrict__ out, const Walk w) {
  constexpr int V = VN<T>, NT = TN<T>, RPT = TM / TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T a2 = *amp_sq;
  for (int t = blockIdx.x; t < w.n_tiles; t += gridDim.x) {
    const int row0 = (t / w.tiles_n) * TM;
    const int col0 = (t % w.tiles_n) * NT;
    const int c = col0 + tx * V;
    if constexpr (D > 0) {
      // the thread's columns' coordinates in registers; each row's are
      // loads that every thread of the warp shares
      T vc[V][DR];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T* col = vs + (size_t)min(c + v, w.n - 1) * D;
#pragma unroll
        for (int k = 0; k < D; ++k) vc[v][k] = col[k];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = row0 + ty + i * TY;
        if (row >= w.m) break;
        const T* ur = us + (size_t)row * D;
        T dist[V];
#pragma unroll
        for (int v = 0; v < V; ++v) dist[v] = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const T u = ur[k];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T diff = u - vc[v][k];
            dist[v] = dist[v] + diff * diff;
          }
        }
        T val[V];
#pragma unroll
        for (int v = 0; v < V; ++v) val[v] = a2 * exp_of(T(-0.5) * dist[v]);
        put<T, ROUTE>(out, val, row, c, w);
      }
    } else {
      // the entries' partial distances in registers, the tile's coordinates
      // staged KC dimensions at a time
      __shared__ T su[KC][TM];
      __shared__ T sv[KC][NT];
      T dist[RPT][V];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) dist[i][v] = T(0);
      for (int k0 = 0; k0 < w.d; k0 += KC) {
        const int kc = min(KC, w.d - k0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TM * kc; idx += THREADS) {
          const int r = idx / kc;
          su[idx - r * kc][r] = us[(size_t)min(row0 + r, w.m - 1) * w.d + k0 + idx - r * kc];
        }
        for (int idx = threadIdx.x; idx < NT * kc; idx += THREADS) {
          const int j = idx / kc;
          sv[idx - j * kc][j] = vs[(size_t)min(col0 + j, w.n - 1) * w.d + k0 + idx - j * kc];
        }
        __syncthreads();
        for (int k = 0; k < kc; ++k) {
          T vk[V];
#pragma unroll
          for (int v = 0; v < V; ++v) vk[v] = sv[k][tx * V + v];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const T u = su[k][ty + i * TY];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const T diff = u - vk[v];
              dist[i][v] = dist[i][v] + diff * diff;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        T val[V];
#pragma unroll
        for (int v = 0; v < V; ++v) val[v] = a2 * exp_of(T(-0.5) * dist[i][v]);
        put<T, ROUTE>(out, val, row0 + ty + i * TY, c, w);
      }
    }
  }
}

template <typename T, int ROUTE>
int launch(const T* us, const T* vs, const T* amp_sq, T* out, const Walk& w, int blocks,
           cudaStream_t stream) {
  sqexp_kernel<T, ROUTE><<<blocks, THREADS, 0, stream>>>(us, vs, amp_sq, out, w);
  return (int)cudaGetLastError();
}

// the plan covers every tile exactly once: tiles tiles of `tile` rows (or
// columns) reach past the last one and tiles - 1 do not
bool covers(int size, int tile, int tiles) {
  return tiles >= 1 && (long)(tiles - 1) * tile < size && (long)tiles * tile >= size;
}

template <typename T>
int sqexp(const void* us, const void* vs, const void* amp_sq, void* out, int m, int n, int d,
          int tile_m, int tile_n, int tiles_m, int tiles_n, int blocks, int route,
          void* stream) {
  if (m < 1 || n < 1 || d < 1 || (D > 0 && d != D) || tile_m != TM || tile_n != TN<T> ||
      !covers(m, tile_m, tiles_m) || !covers(n, tile_n, tiles_n))
    return (int)cudaErrorInvalidValue;
  const long n_tiles = (long)tiles_m * tiles_n;
  if (n_tiles > INT_MAX || blocks < 1 || blocks > n_tiles || route < SCALAR || route > VECTOR)
    return (int)cudaErrorInvalidValue;
  if (route == VECTOR &&
      ((size_t)n * sizeof(T) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const Walk w{m, n, d, tiles_n, (int)n_tiles};
  const T* u = static_cast<const T*>(us);
  const T* v = static_cast<const T*>(vs);
  const T* a = static_cast<const T*>(amp_sq);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == VECTOR) return launch<T, VECTOR>(u, v, a, o, w, blocks, s);
  return launch<T, SCALAR>(u, v, a, o, w, blocks, s);
}

}  // namespace

// out (m, n) = amp_sq[0] * exp(-0.5 * sum_k (us[i, k] - vs[j, k])^2), on
// `stream`, by the plan of pairwise.py::sqexp_plan: tiles of tile_m (32)
// rows by tile_n columns (1 KiB of a row), tiles_m by tiles_n of them
// covering the output exactly once, walked by `blocks` blocks, stored by
// `route` (0 scalar; 1 vector, which needs n * sizeof(T) and out on 16
// bytes). d must be this library's B2_D (any d >= 1 where B2_D is 0).
// Returns 0 on success, cudaErrorInvalidValue for operands or a plan it does
// not take, else the CUDA error code of the launch.
extern "C" int sqexp_f32(const void* us, const void* vs, const void* amp_sq, void* out, int m,
                         int n, int d, int tile_m, int tile_n, int tiles_m, int tiles_n,
                         int blocks, int route, void* stream) {
  return sqexp<float>(us, vs, amp_sq, out, m, n, d, tile_m, tile_n, tiles_m, tiles_n, blocks,
                      route, stream);
}

extern "C" int sqexp_f64(const void* us, const void* vs, const void* amp_sq, void* out, int m,
                         int n, int d, int tile_m, int tile_n, int tiles_m, int tiles_n,
                         int blocks, int route, void* stream) {
  return sqexp<double>(us, vs, amp_sq, out, m, n, d, tile_m, tile_n, tiles_m, tiles_n, blocks,
                       route, stream);
}
