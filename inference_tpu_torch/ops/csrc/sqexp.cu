// Kernel B2: the squared-exponential covariance block, written for Hopper (sm_90a).
//
// Replaces inference_tpu/ops/pairwise.py::_sqexp_pallas, the Pallas kernel
// that pairwise.py::_sqexp_pallas_diff wraps. Its plain PyTorch version is
// inference_tpu_torch/ops/pairwise.py::_sqexp_reference, and the wrapper that
// launches it is _launch_sqexp in the same module.
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
// Against it, each entry costs 3 D + 1 flops and one exp; in double the exp is
// a software sequence of some twenty FP64 instructions, so at D = 2 the FP64
// pipe needs about as long as the store, and the kernel sits between the two
// bounds. The reads (M + N) * D values are negligible.
//
// What the design does about it. One block computes a TILE x TILE (64 x 64)
// output tile with 256 threads as (64 columns) x (4 row groups): each thread
// owns one column and TILE / 4 = 16 rows of it. Consecutive threads of a warp
// own consecutive columns, so every store of a warp is one contiguous run of
// 32 entries (256 bytes in double). The tile's rows of us and vs are staged in
// shared memory, transposed to [k][row], so the column reads are conflict-free
// and the row reads are broadcasts; a thread keeps its column's D coordinates
// in registers. Ragged edges are masked in the kernel: no padding of the
// operands and no slicing copy of the output. Nothing but the output ever goes
// to device memory. Built with --fmad=false and the accurate exp/expf (no fast
// math), so it rounds as the plain version's separate torch operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;                     // output tile edge (pairwise.py _TILE)
constexpr int ROW_GROUPS = 4;                // threads per column of a tile
constexpr int THREADS = TILE * ROW_GROUPS;   // 256
constexpr int ROWS_PER_THREAD = TILE / ROW_GROUPS;
constexpr int D_MAX = 16;                    // pairwise.py D_MAX

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sqexp_tile_kernel(const T* __restrict__ us, const T* __restrict__ vs,
                  const T* __restrict__ amp_sq, T* __restrict__ out,
                  int m, int n, int d) {
  __shared__ T su[D_MAX][TILE];
  __shared__ T sv[D_MAX][TILE];

  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  // stage the tile's rows, zero beyond the ragged edge (never stored)
  for (int idx = tid; idx < TILE * d; idx += THREADS) {
    const int r = idx / d;
    const int k = idx - r * d;
    su[k][r] = row0 + r < m ? us[(size_t)(row0 + r) * d + k] : T(0);
    sv[k][r] = col0 + r < n ? vs[(size_t)(col0 + r) * d + k] : T(0);
  }
  __syncthreads();

  const int c = threadIdx.x;
  const int col = col0 + c;
  if (col >= n) return;

  T vc[D_MAX];
#pragma unroll
  for (int k = 0; k < D_MAX; ++k) vc[k] = k < d ? sv[k][c] : T(0);

  const T a2 = *amp_sq;
  T* out_col = out + col;
#pragma unroll 4
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = threadIdx.y + i * ROW_GROUPS;
    const int row = row0 + r;
    if (row >= m) break;
    T dist = T(0);
#pragma unroll
    for (int k = 0; k < D_MAX; ++k) {
      if (k < d) {
        const T diff = su[k][r] - vc[k];
        dist = dist + diff * diff;
      }
    }
    out_col[(size_t)row * n] = a2 * exp_of(T(-0.5) * dist);
  }
}

template <typename T>
int launch(const T* us, const T* vs, const T* amp_sq, T* out, int m, int n,
           int d, cudaStream_t stream) {
  if (m < 1 || n < 1 || d < 1 || d > D_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  dim3 block(TILE, ROW_GROUPS);
  sqexp_tile_kernel<T><<<grid, block, 0, stream>>>(us, vs, amp_sq, out, m, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// out (m, n) = amp_sq[0] * exp(-0.5 * sum_k (us[i, k] - vs[j, k])^2), on `stream`.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sqexp_f32(const void* us, const void* vs, const void* amp_sq,
                         void* out, int m, int n, int d, void* stream) {
  return launch<float>(static_cast<const float*>(us), static_cast<const float*>(vs),
                       static_cast<const float*>(amp_sq), static_cast<float*>(out),
                       m, n, d, static_cast<cudaStream_t>(stream));
}

extern "C" int sqexp_f64(const void* us, const void* vs, const void* amp_sq,
                         void* out, int m, int n, int d, void* stream) {
  return launch<double>(static_cast<const double*>(us), static_cast<const double*>(vs),
                        static_cast<const double*>(amp_sq), static_cast<double*>(out),
                        m, n, d, static_cast<cudaStream_t>(stream));
}
