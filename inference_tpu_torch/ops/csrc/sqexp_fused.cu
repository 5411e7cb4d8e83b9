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
// Above d = 16: sqexp_fused_wide_kernel (sqexp_fused_wide_f64). It computes
// the same sums in the same order as the templated kernel for any d: each
// entry's distance over k in order, the accurate exp, each row's sum over j
// within one thread in column order. What bounds it is FP64 issue again, and
// more of it: per entry 3 d + 1 operations, the exp's ~18 and q fma, 80 at d
// = 20, q = 1 (13.6 ms of issue at n = 53,248 on 132 SMs x 64 lanes x 1.98
// GHz), each sub, mul and add a whole FP64 instruction under --fmad=false.
//
// What the design does about it:
// - A 2-D micro-tile. Each thread keeps 1 row x JC = 16 consecutive columns
//   of partial distances in registers, so each row value it reads serves 16
//   entries: per pair of dimensions 1 + 16 16-byte shared-memory loads for 96
//   FP64 instructions. One row a thread, by measurement on the H100 (PERF.md):
//   the shared memory of a block's rows scales with the rows a thread, and at
//   d = 20 one row leaves room for three blocks an SM at q = 1, faster than
//   the two of 2 x 8 or the one of 4 x 4; 16 columns beat 8 and 32.
// - Staged once, read as pairs. The block's 128 rows are staged into shared
//   memory as [dims / 2][rows] pairs (a warp's read of its rows' dimensions
//   k, k + 1 is 512 contiguous bytes, no bank conflict), and every 128-column
//   tile of the split as [column][dims] (each read of dimensions k, k + 1 of
//   a column is one 16-byte broadcast), both by cp.async from the row-major
//   coordinates: no transpose, no copy by the wrapper. The column tiles are
//   double buffered: the next one's copy and its v (widened to double through
//   registers) are in flight while one is computed, with one barrier per
//   tile.
// - Chunks that unroll. d is zero-padded to d_pad, a multiple of KC = 4, in
//   the staged copies; adding (0 - 0)^2 = +0 to a non-negative distance
//   leaves every sum bit for bit, so the k loop runs whole unrolled steps of
//   KC with no predicate and no 64-bit address arithmetic.
// - Wide d in chunks. Where the rows and two column tiles of all d_pad
//   dimensions do not fit in shared memory beside v (d_pad above 64-72, by q),
//   the block walks each tile in chunks of DC = 16 dimensions: the rows'
//   chunk and the tile's are staged (double buffered) for each, and the
//   tile's 128 x 128 partial distances wait in shared memory between chunks,
//   each thread's own column of them, so no barrier guards them. Every
//   distance is still summed over k in order, so the chunks change no bit.
//   A chunk's place in its tile (first, last) is a template parameter of its
//   code, so a tile of one chunk (d = 20) runs neither a branch nor a
//   shared-memory round trip for the chunks.
// - Three blocks an SM up to QMAX 2 (launch bounds: at most 168 registers),
//   which their shared memory at d = 20 allows; left to itself, ptxas gave
//   the four copies of the chunk code 184 registers at q = 1, two blocks.
// The plan (df64.fused_wide_plan: column splits, d_pad, the chunk, shared
// memory) is taken as given and checked. On the H100 it runs at about 1.17x
// its issue time at d = 20, q = 1: the exp at its share, the distance loop at
// about 1.2x its FP64 time (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 128;   // threads per block (df64.py _TI)
constexpr int TJ = 128;     // columns per staged tile (df64.py _TJ)
constexpr int D_MAX = 16;   // df64.py D_MAX
constexpr int KC = 4;       // dimensions per unrolled step of the wide kernel (df64.py WIDE_KC)
constexpr int JC = 16;      // columns of a wide kernel thread's micro-tile (df64.py WIDE_JC)
constexpr int DC = 16;      // dimensions a chunk where d_pad's do not fit (df64.py WIDE_DC)
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of a block (df64.py SMEM_MAX)

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

// cp.async of 8 bytes from device to shared memory, through the L1
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage dimensions [k0, k0 + kw) of TJ = ROWS points of the row-major (n, d)
// coordinates from src (the first point's row) into shared memory at dst(p,
// k), the block's threads in turn: the real ones (points below n_real,
// dimensions below d) through cp.async, a point's dimensions and then the
// next point's, with (p, k) and the source advancing by fixed steps (no
// division and no 64-bit product in the loop); then plain stores of 0 in the
// pad dimensions up to kw (a multiple of KC) and in the points from n_real on.
static_assert(TJ == ROWS, "stage() copies a column tile or the block's rows alike");
template <typename Dst>
__device__ __forceinline__ void stage(const double* __restrict__ src, int n_real, int d, int k0,
                                      int kw, Dst dst) {
  const int kr = min(kw, d - k0), n = min(n_real, TJ);  // real dimensions and points
  const int step_p = ROWS / kr, step_k = ROWS - step_p * kr;
  int p = threadIdx.x / kr, k = threadIdx.x - p * kr;
  const double* from = src + p * d + k0 + k;
  for (int idx = threadIdx.x; idx < n * kr; idx += ROWS) {
    cp_async8(dst(p, k), from);
    k += step_k;
    p += step_p;
    from += step_p * d + step_k;
    if (k >= kr) {
      k -= kr;
      ++p;
      from += d - kr;
    }
  }
  for (int idx = threadIdx.x; idx < n * (kw - kr); idx += ROWS)
    *dst(idx / (kw - kr), kr + idx % (kw - kr)) = 0.0;
  for (int idx = threadIdx.x; idx < (TJ - n) * kw; idx += ROWS) *dst(n + idx / kw, idx % kw) = 0.0;
}

// One chunk of one staged tile for the thread's row (sr: its pairs of the
// chunk's dimensions; ct: the tile's columns, dc a row; vt: the tile's v):
// the distances of each 16 columns, from 0 in the FIRST chunk, else from the
// thread's column of sdist, over the chunk's kw dimensions; in the LAST, the
// exps and their fma into acc in column order, else back into sdist. The
// chunk's place is a template parameter, so that a tile of one chunk runs
// no branch and no shared-memory round trip for it.
template <int QMAX, bool FIRST, bool LAST>
__device__ __forceinline__ void tile_chunk(const double2* __restrict__ sr,
                                           const double* __restrict__ ct,
                                           const double* __restrict__ vt, double* sdist, int dc,
                                           int kw, double (&acc)[QMAX]) {
  for (int g = 0; g < TJ; g += JC) {
    double dist[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j) dist[j] = FIRST ? 0.0 : sdist[(g + j) * ROWS + threadIdx.x];
    const double* cg = ct + g * dc;
    for (int k = 0; k < kw; k += KC) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 2) {
        const double2 a = sr[((k + kk) >> 1) * ROWS];
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const double2 c = *reinterpret_cast<const double2*>(cg + j * dc + k + kk);
          const double e0 = a.x - c.x;
          dist[j] = dist[j] + e0 * e0;
          const double e1 = a.y - c.y;
          dist[j] = dist[j] + e1 * e1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      if constexpr (LAST) {
        const double e = exp(-0.5 * dist[j]);
#pragma unroll
        for (int c = 0; c < QMAX; ++c) acc[c] = fma(e, vt[(g + j) * QMAX + c], acc[c]);
      } else {
        sdist[(g + j) * ROWS + threadIdx.x] = dist[j];
      }
    }
  }
}

// d > D_MAX (see the header): the block's ROWS rows against the column tiles
// of its split, in units of (tile, chunk of dc dimensions). Dynamic shared
// memory: the rows as [dc / 2][ROWS] pairs (two buffers where there are two
// or more chunks, else one, staged once), two column tiles [TJ][dc], two
// tiles of v [TJ][QMAX], and, where there are two or more chunks, the
// partial distances of a tile [TJ][ROWS]. Up to QMAX 2, three blocks an SM
// (at most 168 registers): at d = 20 their shared memory fits three.
template <int QMAX>
__global__ void __launch_bounds__(ROWS, QMAX <= 2 ? 3 : 1)
sqexp_fused_wide_kernel(const double* __restrict__ rows, const double* __restrict__ cols,
                        const float* __restrict__ v, double* __restrict__ partial, int n_rows,
                        int n_cols, int d, int d_pad, int dc, int q, int tiles_per_split) {
  extern __shared__ __align__(16) double smem[];
  const int n_chunks = (d_pad + dc - 1) / dc;
  const int row_bufs = n_chunks > 1 ? 2 : 1;
  double* srow = smem;                                  // [row_bufs][dc / 2][ROWS] pairs
  double* scol = srow + (size_t)row_bufs * ROWS * dc;   // [2][TJ][dc]
  double* sv = scol + (size_t)2 * TJ * dc;              // [2][TJ][QMAX]
  double* sdist = sv + 2 * TJ * QMAX;                   // [TJ][ROWS], two or more chunks

  const int tid = threadIdx.x;
  const int row_base = blockIdx.x * ROWS;
  double acc[QMAX];
#pragma unroll
  for (int c = 0; c < QMAX; ++c) acc[c] = 0.0;

  const int t_begin = blockIdx.y * tiles_per_split;
  const int units = (min(t_begin + tiles_per_split, n_cols / TJ) - t_begin) * n_chunks;
  // unit u's column chunk, and its row chunk where chunks follow one another
  // (zeros for the rows past n_rows, computed and not stored), into buffer b
  auto stage_unit = [&](int u, int b) {
    const int t = t_begin + u / n_chunks, k0 = u % n_chunks * dc, kw = min(dc, d_pad - k0);
    double* sc = scol + (size_t)b * TJ * dc;
    stage(cols + (size_t)t * TJ * d, TJ, d, k0, kw, [&](int j, int k) { return sc + j * dc + k; });
    if (u == 0 || n_chunks > 1) {
      double* sr = srow + (size_t)(row_bufs - 1) * b * ROWS * dc;
      stage(rows + (size_t)row_base * d, n_rows - row_base, d, k0, kw,
            [&](int r, int k) { return sr + (k >> 1) * 2 * ROWS + 2 * r + (k & 1); });
    }
  };
  auto load_v = [&](int t, float (&w)[QMAX]) {  // column tid of tile t
#pragma unroll
    for (int c = 0; c < QMAX; ++c) w[c] = c < q ? v[((size_t)t * TJ + tid) * q + c] : 0.0f;
  };
  auto store_v = [&](const float (&w)[QMAX], int b) {
#pragma unroll
    for (int c = 0; c < QMAX; ++c) sv[(b * TJ + tid) * QMAX + c] = (double)w[c];
  };

  if (units > 0) {
    stage_unit(0, 0);
    float w[QMAX];
    load_v(t_begin, w);
    store_v(w, 0);
  }
  cp_async_commit();

  for (int u = 0; u < units; ++u) {
    const int b = u & 1, tile = u / n_chunks, chunk = u % n_chunks;
    const bool first = chunk == 0, last = chunk == n_chunks - 1;
    cp_async_wait_all();
    __syncthreads();  // unit u staged; every thread done with unit u - 1
    const bool next_tile = last && u + 1 < units;
    float w_next[QMAX];
    if (u + 1 < units) {
      stage_unit(u + 1, b ^ 1);
      cp_async_commit();
      if (next_tile) load_v(t_begin + tile + 1, w_next);
    }
    const double2* sr =
        reinterpret_cast<const double2*>(srow + (size_t)(row_bufs - 1) * b * ROWS * dc) + tid;
    const double* ct = scol + (size_t)b * TJ * dc;
    const double* vt = sv + (tile & 1) * TJ * QMAX;
    const int kw = min(dc, d_pad - chunk * dc);
    if (first && last) tile_chunk<QMAX, true, true>(sr, ct, vt, sdist, dc, kw, acc);
    else if (first) tile_chunk<QMAX, true, false>(sr, ct, vt, sdist, dc, kw, acc);
    else if (last) tile_chunk<QMAX, false, true>(sr, ct, vt, sdist, dc, kw, acc);
    else tile_chunk<QMAX, false, false>(sr, ct, vt, sdist, dc, kw, acc);
    if (next_tile) store_v(w_next, (tile + 1) & 1);
  }
  const int row = row_base + tid;
  if (row < n_rows) {
    double* out = partial + ((size_t)blockIdx.y * n_rows + row) * q;
#pragma unroll
    for (int c = 0; c < QMAX; ++c)
      if (c < q) out[c] = acc[c];
  }
}

// the launch of one instantiation of the templated kernel; refuses rows per
// thread other than RPT
template <int DT, int QMAX, int RPT>
int launch_q(const double* rows, const double* cols, const float* v, double* partial,
             int n_rows, int n_cols, int d, int q, int rpt, int splits, int tiles_per_split,
             cudaStream_t stream) {
  if (rpt != RPT) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + ROWS * RPT - 1) / (ROWS * RPT), splits);
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

// the wide kernel's chunk of dimensions and shared memory for q's bucket:
// all d_pad dimensions where the rows and two column tiles of them fit
// beside v's tiles, else chunks of DC with the tile's distances; the
// plan's (df64.py fused_wide_plan) must equal them
constexpr int wide_dc(int qmax, int d_pad) {
  return 8 * ((size_t)d_pad * (ROWS + 2 * TJ) + (size_t)2 * TJ * qmax) <= SMEM_MAX ? d_pad : DC;
}
constexpr size_t wide_smem(int qmax, int d_pad) {
  return wide_dc(qmax, d_pad) == d_pad
             ? 8 * ((size_t)d_pad * (ROWS + 2 * TJ) + (size_t)2 * TJ * qmax)
             : 8 * ((size_t)DC * (2 * ROWS + 2 * TJ) + (size_t)2 * TJ * qmax + (size_t)TJ * ROWS);
}

// the launch of one instantiation of the wide kernel; refuses a plan whose
// d_pad, chunk or shared memory differ from its own
template <int QMAX>
int launch_wide_q(const double* rows, const double* cols, const float* v, double* partial,
                  int n_rows, int n_cols, int d, int q, int splits, int tiles_per_split,
                  int d_pad, int dc, int smem, cudaStream_t stream) {
  if (d_pad != (d + KC - 1) / KC * KC || dc != wide_dc(QMAX, d_pad) ||
      (size_t)smem != wide_smem(QMAX, d_pad))
    return (int)cudaErrorInvalidValue;
  auto kernel = sqexp_fused_wide_kernel<QMAX>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((n_rows + ROWS - 1) / ROWS, splits);
  kernel<<<grid, ROWS, smem, stream>>>(rows, cols, v, partial, n_rows, n_cols, d, d_pad, dc, q,
                                       tiles_per_split);
  return (int)cudaGetLastError();
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

// The same for d > 16 by the plan of df64.py::fused_wide_plan: d_pad = d
// rounded up to a multiple of 4, dc dimensions a chunk (all of d_pad where
// they fit, else DC) and smem bytes of dynamic shared memory, as the
// instantiation for q's bucket computes them. rows (n_rows, d) and cols
// (n_cols, d) are row-major. The limits on n_cols, q and the splits are
// those above.
extern "C" int sqexp_fused_wide_f64(const void* rows, const void* cols, const void* v,
                                    void* partial, int n_rows, int n_cols, int d, int q,
                                    int splits, int tiles_per_split, int d_pad, int dc, int smem,
                                    void* stream) {
  if (d <= D_MAX || !plan_ok(n_rows, n_cols, d, q, splits, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  const double* r = static_cast<const double*>(rows);
  const double* c = static_cast<const double*>(cols);
  const float* vv = static_cast<const float*>(v);
  double* p = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q <= 1) return launch_wide_q<1>(r, c, vv, p, n_rows, n_cols, d, q, splits, tiles_per_split, d_pad, dc, smem, s);
  if (q <= 2) return launch_wide_q<2>(r, c, vv, p, n_rows, n_cols, d, q, splits, tiles_per_split, d_pad, dc, smem, s);
  if (q <= 4) return launch_wide_q<4>(r, c, vv, p, n_rows, n_cols, d, q, splits, tiles_per_split, d_pad, dc, smem, s);
  if (q <= 8) return launch_wide_q<8>(r, c, vv, p, n_rows, n_cols, d, q, splits, tiles_per_split, d_pad, dc, smem, s);
  return launch_wide_q<16>(r, c, vv, p, n_rows, n_cols, d, q, splits, tiles_per_split, d_pad, dc, smem, s);
}
