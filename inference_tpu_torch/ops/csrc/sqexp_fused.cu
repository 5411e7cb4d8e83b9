// Kernels B3 and B4: the fused squared-exponential matmat in native FP64, for
// Hopper (sm_90a).
//
// Replaces inference_tpu/ops/df64.py::_matmat_kernel (B4, launched by
// _sqexp_matmat_rect_df64_pallas and its square form) and ::_matvec_kernel
// (B3, launched by _sqexp_matvec_df64_pallas). B3 is the q = 1 launch of this
// kernel, which computes exactly its function. The plain PyTorch version is
// inference_tpu_torch/ops/df64.py::_fused_reference; the wrapper that launches
// it is _launch_fused in the same module, by the launch plan fused_plan.
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
// about 25 + q FP64 instructions against 16.7e12 per second (132 SMs x 64
// lanes x 1.98 GHz), about 4.4 ms at q = 1 and 5.6 ms at q = 8. With one row
// per thread the hot loop issued 58 instructions per entry at q = 1, 25 of
// them FP64: the shared-memory reads of each column, the loop's bookkeeping
// and the exp's integer and move work all compete with the FP64 issue.
//
// What the design does about it. A block of ROWS threads owns ROWS * RPT
// output rows; each thread keeps the d coordinates and q sums of RPT rows,
// ROWS apart, in registers. The block streams the columns through shared
// memory in tiles of TJ, with v widened to double once at staging; every
// thread reads the same tile entry (a broadcast), and each read of a column's
// coordinates and of its q values of v serves RPT entries, as does the loop's
// bookkeeping. At q = 1 that took the hot loop from 58 instructions per entry
// to 46 (still 25 FP64), and the time from 1.71x the bound to 1.41x. RPT is a
// template parameter fixed for each bucket of q (QMAX) by measurement on the
// H100 (PERF.md): 4 up to QMAX 4, 2 at QMAX 8 and 16 (at 16, 4 rows' 64 sums
// and 64 coordinates of the runtime d overflow the 255 registers). The rows of
// a thread past n_rows are computed on the last row's coordinates and not
// stored. The dimension d is a template parameter for d <= 3 (a runtime d
// would issue predicated work for all of D_MAX dimensions per entry), and q is
// looped to the template bound QMAX. On the TPU the grid carried the
// accumulator across the column tiles; here the column range is split over
// blockIdx.y so that enough blocks fill the 132 SMs, and no accumulator
// crosses blocks. The wrapper's plan (rows per thread, splits, tiles per
// split) is taken as given: the launcher checks it and the kernel does not
// re-derive it.
//
// Registers. Left to itself, ptxas fitted each instantiation to an occupancy
// step (64, 80, 96, 128 or 168 registers) and spilled a few bytes in six of
// them. The kernel asks for one block per SM (__launch_bounds__(ROWS, 1)) and
// the build for ptxas's highest register-usage level (_build.KERNEL_FLAGS):
// no instantiation spills, and the extra registers schedule the RPT exps'
// FP64 chains side by side: 1-12% faster, with the same results bit for bit.
// Registers per thread (-Xptxas -v, CUDA 12.8), d = 2 / runtime d, and the
// blocks per SM at d = 2:
//   QMAX 1, RPT 4    112 / 182   4
//   QMAX 2, RPT 4    116 / 196   4
//   QMAX 4, RPT 4    144 / 216   3
//   QMAX 8, RPT 2    114 / 150   4
//   QMAX 16, RPT 2   162 / 204   3
// chip_smoke.py prints every instantiation's registers and local-memory
// instructions.
//
// Above d = 16 (sqexp_fused_wide_f64) no register array holds a row's
// coordinates: the wrapper passes the rows transposed, (d, n_rows), so each
// k's read of a warp's rows is one coalesced load, and the column's
// coordinate at k is one load that every thread of the block shares. Both
// come from device memory (the L1 keeps them), one k at a time, in the
// order of the plain version; v is staged per tile as above. It computes the
// same sums in the same order as the templated kernels and takes the same
// plan, for any d.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 128;   // threads per block (df64.py _TI)
constexpr int TJ = 128;     // columns per staged tile (df64.py _TJ)
constexpr int D_MAX = 16;   // df64.py D_MAX

// a minimum of one block per SM: ptxas keeps the registers it needs rather
// than spill to fit another block (see the header)
template <int DT, int QMAX, int RPT>
__global__ void __launch_bounds__(ROWS, 1)
sqexp_fused_kernel(const double* __restrict__ rows, const double* __restrict__ cols,
                   const float* __restrict__ v, double* __restrict__ partial,
                   int n_rows, int n_cols, int d_runtime, int q, int tiles_per_split) {
  constexpr int DM = DT > 0 ? DT : D_MAX;
  const int d = DT > 0 ? DT : d_runtime;
  __shared__ double sc[DM][TJ];
  __shared__ double sv[TJ][QMAX];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS * RPT + tid;  // the thread's rows: row0 + p * ROWS

  double r[RPT][DM];
  double acc[RPT][QMAX];
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const size_t row = (size_t)min(row0 + p * ROWS, n_rows - 1);
#pragma unroll
    for (int k = 0; k < DM; ++k) r[p][k] = k < d ? rows[row * d + k] : 0.0;
#pragma unroll
    for (int c = 0; c < QMAX; ++c) acc[p][c] = 0.0;
  }

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
      double dist[RPT];
#pragma unroll
      for (int p = 0; p < RPT; ++p) dist[p] = 0.0;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        if (DT > 0 || k < d) {
          const double ck = sc[k][jj];
#pragma unroll
          for (int p = 0; p < RPT; ++p) {
            const double diff = r[p][k] - ck;
            dist[p] = dist[p] + diff * diff;
          }
        }
      }
      double e[RPT];
#pragma unroll
      for (int p = 0; p < RPT; ++p) e[p] = exp(-0.5 * dist[p]);
#pragma unroll
      for (int c = 0; c < QMAX; ++c) {
        const double w = sv[jj][c];
#pragma unroll
        for (int p = 0; p < RPT; ++p) acc[p][c] = fma(e[p], w, acc[p][c]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int row = row0 + p * ROWS;
    if (row < n_rows) {
      double* out = partial + ((size_t)blockIdx.y * n_rows + row) * q;
#pragma unroll
      for (int c = 0; c < QMAX; ++c)
        if (c < q) out[c] = acc[p][c];
    }
  }
}

// d > D_MAX: rows_t is (d, n_rows), the rows transposed; the coordinates
// come from device memory one k at a time (see the header)
template <int QMAX, int RPT>
__global__ void __launch_bounds__(ROWS, 1)
sqexp_fused_wide_kernel(const double* __restrict__ rows_t, const double* __restrict__ cols,
                        const float* __restrict__ v, double* __restrict__ partial,
                        int n_rows, int n_cols, int d, int q, int tiles_per_split) {
  __shared__ double sv[TJ][QMAX];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS * RPT + tid;
  int rr[RPT];
  double acc[RPT][QMAX];
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    rr[p] = min(row0 + p * ROWS, n_rows - 1);
#pragma unroll
    for (int c = 0; c < QMAX; ++c) acc[p][c] = 0.0;
  }

  const int n_tiles = n_cols / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const size_t j0 = (size_t)t * TJ;
    __syncthreads();
    for (int idx = tid; idx < TJ * QMAX; idx += ROWS) {
      const int jj = idx / QMAX;
      const int c = idx - jj * QMAX;
      sv[jj][c] = c < q ? (double)v[(j0 + jj) * q + c] : 0.0;
    }
    __syncthreads();
    for (int jj = 0; jj < TJ; ++jj) {
      const double* col = cols + (j0 + jj) * d;
      double dist[RPT];
#pragma unroll
      for (int p = 0; p < RPT; ++p) dist[p] = 0.0;
      for (int k = 0; k < d; ++k) {
        const double ck = __ldg(col + k);
        const double* row_k = rows_t + (size_t)k * n_rows;
#pragma unroll
        for (int p = 0; p < RPT; ++p) {
          const double diff = __ldg(row_k + rr[p]) - ck;
          dist[p] = dist[p] + diff * diff;
        }
      }
      double e[RPT];
#pragma unroll
      for (int p = 0; p < RPT; ++p) e[p] = exp(-0.5 * dist[p]);
#pragma unroll
      for (int c = 0; c < QMAX; ++c) {
        const double w = sv[jj][c];
#pragma unroll
        for (int p = 0; p < RPT; ++p) acc[p][c] = fma(e[p], w, acc[p][c]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int row = row0 + p * ROWS;
    if (row < n_rows) {
      double* out = partial + ((size_t)blockIdx.y * n_rows + row) * q;
#pragma unroll
      for (int c = 0; c < QMAX; ++c)
        if (c < q) out[c] = acc[p][c];
    }
  }
}

// the launch of one instantiation; refuses rows per thread other than RPT.
// DT < 0 is the wide kernel, with rows transposed
template <int DT, int QMAX, int RPT>
int launch_q(const double* rows, const double* cols, const float* v, double* partial,
             int n_rows, int n_cols, int d, int q, int rpt, int splits, int tiles_per_split,
             cudaStream_t stream) {
  if (rpt != RPT) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + ROWS * RPT - 1) / (ROWS * RPT), splits);
  if constexpr (DT < 0)
    sqexp_fused_wide_kernel<QMAX, RPT><<<grid, ROWS, 0, stream>>>(
        rows, cols, v, partial, n_rows, n_cols, d, q, tiles_per_split);
  else
    sqexp_fused_kernel<DT, QMAX, RPT><<<grid, ROWS, 0, stream>>>(
        rows, cols, v, partial, n_rows, n_cols, d, q, tiles_per_split);
  return (int)cudaGetLastError();
}

// one RPT for each bucket of q (df64.py FUSED_RPT holds the same table)
template <int DT>
int launch_d(const double* rows, const double* cols, const float* v, double* partial,
             int n_rows, int n_cols, int d, int q, int rpt, int splits, int tiles_per_split,
             cudaStream_t s) {
  if (q <= 1) return launch_q<DT, 1, 4>(rows, cols, v, partial, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
  if (q <= 2) return launch_q<DT, 2, 4>(rows, cols, v, partial, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
  if (q <= 4) return launch_q<DT, 4, 4>(rows, cols, v, partial, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
  if (q <= 8) return launch_q<DT, 8, 2>(rows, cols, v, partial, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
  return launch_q<DT, 16, 2>(rows, cols, v, partial, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
}

// the operands and the plan, else false (see the entry points)
bool plan_ok(int n_rows, int n_cols, int d, int q, int splits, int tiles_per_split) {
  if (n_rows < 1 || n_cols < TJ || n_cols % TJ != 0 || d < 1 || q < 1 || q > 16) return false;
  const long n_tiles = n_cols / TJ;
  return tiles_per_split >= 1 && splits >= 1 && splits <= 65535 &&
         (long)splits * tiles_per_split >= n_tiles && (long)(splits - 1) * tiles_per_split < n_tiles;
}

}  // namespace

// partial (splits, n_rows, q) = the column splits' sums of
// exp(-0.5 |rows_i - cols_j|^2) v[j, :], on `stream`, by the plan of
// df64.py::fused_plan: rpt output rows per thread, column split s over the
// tiles [s * tiles_per_split, (s + 1) * tiles_per_split) cut at n_cols / 128.
// n_cols must be a multiple of 128, 1 <= q <= 16, 1 <= d <= 16; the splits
// must cover the column tiles with none empty, and rpt must be the one
// instantiated for q. Returns the CUDA error code of the launch (0 on
// success), cudaErrorInvalidValue for operands or a plan it does not take.
extern "C" int sqexp_fused_f64(const void* rows, const void* cols, const void* v,
                               void* partial, int n_rows, int n_cols, int d, int q, int rpt,
                               int splits, int tiles_per_split, void* stream) {
  if (d > D_MAX || !plan_ok(n_rows, n_cols, d, q, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  const double* r = static_cast<const double*>(rows);
  const double* c = static_cast<const double*>(cols);
  const float* vv = static_cast<const float*>(v);
  double* p = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_d<1>(r, c, vv, p, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
    case 2: return launch_d<2>(r, c, vv, p, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
    case 3: return launch_d<3>(r, c, vv, p, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
    default: return launch_d<0>(r, c, vv, p, n_rows, n_cols, d, q, rpt, splits, tiles_per_split, s);
  }
}

// The same for d > 16, with rows_t the rows transposed, (d, n_rows)
// row-major; the plan and the limits on n_cols and q are those above.
extern "C" int sqexp_fused_wide_f64(const void* rows_t, const void* cols, const void* v,
                                    void* partial, int n_rows, int n_cols, int d, int q, int rpt,
                                    int splits, int tiles_per_split, void* stream) {
  if (d <= D_MAX || !plan_ok(n_rows, n_cols, d, q, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  return launch_d<-1>(static_cast<const double*>(rows_t), static_cast<const double*>(cols),
                      static_cast<const float*>(v), static_cast<double*>(partial), n_rows,
                      n_cols, d, q, rpt, splits, tiles_per_split,
                      static_cast<cudaStream_t>(stream));
}
