// Kernels B3 and B4: the fused squared-exponential matmat in native FP64, for
// Hopper (sm_90a).
//
// Replaces inference_tpu/ops/df64.py::_matmat_kernel (B4, launched by
// _sqexp_matmat_rect_df64_pallas and its square form) and ::_matvec_kernel
// (B3, launched by _sqexp_matvec_df64_pallas). B3 is the q = 1 launch of this
// kernel, which computes exactly its function. The plain PyTorch version is
// inference_tpu_torch/ops/df64.py::_fused_reference; the wrapper that launches
// it is _launch_fused in the same module.
//
// What it computes. For pre-scaled FP64 coordinates rows (n_rows, d) and cols
// (n_cols, d), row-major, and float32 right-hand sides v (n_cols, q):
//   E_ij = exp(-0.5 * sum_k (rows[i, k] - cols[j, k])^2)
//   Y[i, c] = sum_j E_ij * v[j, c]
// Column split s of the launch writes its partial sums to partial[s] (n_rows,
// q); the wrapper adds the splits. The TPU kernel carried every quantity as a
// pair of float32 words because the TPU has no float64; the card has, so the
// same function runs here in native FP64. The entry is formed exactly as
// kernel B5 and the plain version form it: dist = dist + diff * diff over k
// in order (the build uses --fmad=false), then exp(-0.5 * dist) with the
// accurate exp; only the accumulation over j uses explicit fma.
//
// What bounds it on this card. Nothing but the coordinates, v and the n_rows x
// q result touch device memory, so it is bound by FP64 issue: per entry 3 d
// operations for the distance, one for the scale, CUDA's double exp (a range
// reduction, a polynomial by Horner's rule and a scaling: some eighteen FP64
// instructions) and q fma. At n = 53,248, d = 2 that is 2.8e9 entries times
// about 25 + q instructions against 16.7e12 FP64 instructions per second
// (132 SMs x 64 lanes x 1.98 GHz), about 4.4 ms at q = 1 and 5.6 ms at q = 8.
//
// What the design does about it. One thread owns one output row and keeps its
// d coordinates and its q sums in registers; a block of ROWS threads streams
// the columns through shared memory in tiles of TJ, with v widened to double
// once at staging, so every thread reads the same tile entry (a broadcast) and
// the inner loop is FP64 arithmetic only. The dimension d is a template
// parameter for d <= 3 (a runtime d would issue predicated work for all of
// D_MAX dimensions per entry), and q is looped to the template bound QMAX. On
// the TPU the grid carried the accumulator across the column tiles; here the
// column range is split over blockIdx.y so that enough blocks fill the 132 SMs,
// and no accumulator crosses blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 128;   // output rows per block, one per thread (df64.py _TI)
constexpr int TJ = 128;     // columns per staged tile (df64.py _TJ)
constexpr int D_MAX = 16;   // df64.py D_MAX

template <int DT, int QMAX>
__global__ void __launch_bounds__(ROWS)
sqexp_fused_kernel(const double* __restrict__ rows, const double* __restrict__ cols,
                   const float* __restrict__ v, double* __restrict__ partial,
                   int n_rows, int n_cols, int d_runtime, int q, int tiles_per_split) {
  constexpr int DM = DT > 0 ? DT : D_MAX;
  const int d = DT > 0 ? DT : d_runtime;
  __shared__ double sc[DM][TJ];
  __shared__ double sv[TJ][QMAX];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * ROWS + tid;
  const bool live = row < n_rows;

  double r[DM];
#pragma unroll
  for (int k = 0; k < DM; ++k) r[k] = (live && k < d) ? rows[(size_t)row * d + k] : 0.0;
  double acc[QMAX];
#pragma unroll
  for (int c = 0; c < QMAX; ++c) acc[c] = 0.0;

  const int n_tiles = n_cols / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const size_t j0 = (size_t)t * TJ;
    __syncthreads();
    for (int idx = tid; idx < TJ * d; idx += ROWS) {
      const int jj = idx / d;
      const int k = idx - jj * d;
      sc[k][jj] = cols[(j0 + jj) * d + k];
    }
    for (int idx = tid; idx < TJ * QMAX; idx += ROWS) {
      const int jj = idx / QMAX;
      const int c = idx - jj * QMAX;
      sv[jj][c] = c < q ? (double)v[(j0 + jj) * q + c] : 0.0;
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < TJ; ++jj) {
      double dist = 0.0;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        if (DT > 0 || k < d) {
          const double diff = r[k] - sc[k][jj];
          dist = dist + diff * diff;
        }
      }
      const double e = exp(-0.5 * dist);
#pragma unroll
      for (int c = 0; c < QMAX; ++c) acc[c] = fma(e, sv[jj][c], acc[c]);
    }
  }
  if (!live) return;
  double* out = partial + ((size_t)blockIdx.y * n_rows + row) * q;
#pragma unroll
  for (int c = 0; c < QMAX; ++c)
    if (c < q) out[c] = acc[c];
}

template <int DT, int QMAX>
int launch_q(const double* rows, const double* cols, const float* v, double* partial,
             int n_rows, int n_cols, int d, int q, int splits, cudaStream_t stream) {
  const int n_tiles = n_cols / TJ;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((n_rows + ROWS - 1) / ROWS, splits);
  sqexp_fused_kernel<DT, QMAX><<<grid, ROWS, 0, stream>>>(
      rows, cols, v, partial, n_rows, n_cols, d, q, tiles_per_split);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_d(const double* rows, const double* cols, const float* v, double* partial,
             int n_rows, int n_cols, int d, int q, int splits, cudaStream_t stream) {
  if (q <= 1) return launch_q<DT, 1>(rows, cols, v, partial, n_rows, n_cols, d, q, splits, stream);
  if (q <= 2) return launch_q<DT, 2>(rows, cols, v, partial, n_rows, n_cols, d, q, splits, stream);
  if (q <= 4) return launch_q<DT, 4>(rows, cols, v, partial, n_rows, n_cols, d, q, splits, stream);
  if (q <= 8) return launch_q<DT, 8>(rows, cols, v, partial, n_rows, n_cols, d, q, splits, stream);
  return launch_q<DT, 16>(rows, cols, v, partial, n_rows, n_cols, d, q, splits, stream);
}

}  // namespace

// partial (splits, n_rows, q) = the column splits' sums of
// exp(-0.5 |rows_i - cols_j|^2) v[j, :], on `stream`. n_cols must be a
// multiple of 128, 1 <= q <= 16, 1 <= d <= 16, splits >= 1. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int sqexp_fused_f64(const void* rows, const void* cols, const void* v,
                               void* partial, int n_rows, int n_cols, int d, int q,
                               int splits, void* stream) {
  if (n_rows < 1 || n_cols < TJ || n_cols % TJ != 0 || d < 1 || d > D_MAX || q < 1 ||
      q > 16 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const double* r = static_cast<const double*>(rows);
  const double* c = static_cast<const double*>(cols);
  const float* vv = static_cast<const float*>(v);
  double* p = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_d<1>(r, c, vv, p, n_rows, n_cols, d, q, splits, s);
    case 2: return launch_d<2>(r, c, vv, p, n_rows, n_cols, d, q, splits, s);
    case 3: return launch_d<3>(r, c, vv, p, n_rows, n_cols, d, q, splits, s);
    default: return launch_d<0>(r, c, vv, p, n_rows, n_cols, d, q, splits, s);
  }
}
