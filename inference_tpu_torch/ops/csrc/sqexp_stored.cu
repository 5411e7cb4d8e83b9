// Kernels B6 and B8: the product of the stored squared-exponential entries
// with a block of right-hand sides, accumulated in native FP64, for Hopper
// (sm_90a).
//
// B6 replaces inference_tpu/ops/df64.py::_stored_matmat_kernel (launched by
// _sqexp_stored_matmat_pallas), which contracted a float32-pair entry store
// with pair products and compensated sums because the TPU has no float64.
// Here the store is kernel B5's FP64 (n, n) matrix and the sums are FP64. B8
// replaces _stored_f32_matmat_kernel (launched by
// _sqexp_stored_f32_matmat_pallas), which contracted kernel B7's float32 store
// with exact Dekker products and compensated pair sums: here a float32 entry
// times a float32 right-hand side, both widened to double, is exact (24 + 24
// significant bits fit in FP64's 53), and the sums are FP64. The plain PyTorch
// versions are inference_tpu_torch/ops/df64.py::_stored_reference (both); the
// wrappers that launch them are _launch_stored and _launch_stored_f32 in the
// same module.
//
// What it computes. For E (n_rows, n_cols), FP64 (B6) or float32 (B8),
// row-major, and float32 right-hand sides v (n_cols, q):
//   y[i, c] = sum_j E[i, j] * v[j, c]
// with E and v widened to double and each product added by fma.
//
// What bounds it on this card. The read of E, once per launch for all q
// columns: at n = 53,248, 22.7 GB (B6) or 11.3 GB (B8), 6.8 or 3.4 ms at
// 3.35 TB/s. The FP64 work is q fma per entry, under that bound for q <= 16
// (2.8e9 q against 16.7e12 FP64 instructions per second).
//
// What the design does about it. A warp owns RPW rows; for a tile of TJ = 128
// columns each lane reads 4 entries of each of its rows, so every load
// instruction of a warp is one contiguous run of a row (256 bytes for B6, 128
// for B8), and the loads are streaming (__ldcs: E is far larger than the 50 MB
// L2 and is not read again in the launch). The tile's v rows are staged in
// shared memory, widened to double and laid out [column][row] so the lanes
// read consecutive words; a block of 8 warps shares each staged tile, so v is
// read from L2 once per 8 RPW rows of E. Each lane keeps RPW x QMAX partial
// sums in registers (at most 16 doubles), and a warp shuffle adds the lanes'
// sums at the end; no sum crosses warps or blocks.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TJ = 128;                // columns per staged tile (df64.py _TJ)
constexpr int PER_LANE = TJ / 32;      // entries of a row a lane reads per tile

template <typename TE, int QMAX, int RPW>
__global__ void __launch_bounds__(THREADS)
sqexp_stored_kernel(const TE* __restrict__ E, const float* __restrict__ v,
                    double* __restrict__ y, int n_rows, int n_cols, int q) {
  __shared__ double sv[QMAX][TJ];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * WARPS + warp) * RPW;

  const TE* erow[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) erow[r] = E + (size_t)min(row0 + r, n_rows - 1) * n_cols;
  double acc[RPW][QMAX];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < QMAX; ++c) acc[r][c] = 0.0;

  for (int j0 = 0; j0 < n_cols; j0 += TJ) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < TJ * QMAX; idx += THREADS) {
      const int jj = idx / QMAX;
      const int c = idx - jj * QMAX;
      sv[c][jj] = c < q ? (double)v[(size_t)(j0 + jj) * q + c] : 0.0;
    }
    __syncthreads();
    double e[RPW][PER_LANE];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) e[r][u] = (double)__ldcs(erow[r] + j0 + lane + 32 * u);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u)
#pragma unroll
      for (int c = 0; c < QMAX; ++c) {
        const double w = sv[c][lane + 32 * u];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][c] = fma(e[r][u], w, acc[r][c]);
      }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < QMAX; ++c) {
      double s = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[r][c] = s;
    }
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= n_rows) break;
#pragma unroll
    for (int c = 0; c < QMAX; ++c)
      if (c < q) y[(size_t)row * q + c] = acc[r][c];
  }
}

template <typename TE, int QMAX, int RPW>
int launch(const TE* E, const float* v, double* y, int n_rows, int n_cols, int q,
           cudaStream_t stream) {
  const int rows_per_block = WARPS * RPW;
  dim3 grid((n_rows + rows_per_block - 1) / rows_per_block);
  sqexp_stored_kernel<TE, QMAX, RPW><<<grid, THREADS, 0, stream>>>(E, v, y, n_rows, n_cols, q);
  return (int)cudaGetLastError();
}

template <typename TE>
int stored(const void* E, const void* v, void* y, int n_rows, int n_cols, int q,
           void* stream) {
  if (n_rows < 1 || n_cols < TJ || n_cols % TJ != 0 || q < 1 || q > 16)
    return (int)cudaErrorInvalidValue;
  const TE* e = static_cast<const TE*>(E);
  const float* vv = static_cast<const float*>(v);
  double* out = static_cast<double*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 1) return launch<TE, 1, 4>(e, vv, out, n_rows, n_cols, q, s);
  if (q <= 2) return launch<TE, 2, 4>(e, vv, out, n_rows, n_cols, q, s);
  if (q <= 4) return launch<TE, 4, 4>(e, vv, out, n_rows, n_cols, q, s);
  if (q <= 8) return launch<TE, 8, 2>(e, vv, out, n_rows, n_cols, q, s);
  return launch<TE, 16, 1>(e, vv, out, n_rows, n_cols, q, s);
}

}  // namespace

// Kernel B6: y (n_rows, q) FP64 = E (n_rows, n_cols) FP64 @ v (n_cols, q)
// float32, on `stream`. n_cols must be a positive multiple of 128 and
// 1 <= q <= 16. Returns the CUDA error code of the launch (0 on success).
extern "C" int sqexp_stored_f64(const void* E, const void* v, void* y, int n_rows,
                                int n_cols, int q, void* stream) {
  return stored<double>(E, v, y, n_rows, n_cols, q, stream);
}

// Kernel B8: the same with E float32.
extern "C" int sqexp_stored_f32(const void* E, const void* v, void* y, int n_rows,
                                int n_cols, int q, void* stream) {
  return stored<float>(E, v, y, n_rows, n_cols, q, stream);
}
