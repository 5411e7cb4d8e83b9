// Probe P2: kernel B3 stripped stage by stage, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of benchmarks/df64_ablate.py::main (kernels
// :45-120, launched at :135), which timed stripped variants of the TPU's pair-
// arithmetic matvec. The plain PyTorch version is inference_tpu_torch/probes/
// df64_ablate.py::_ablate_reference; the wrapper that launches this kernel is
// _launch_ablate in the same module.
//
// What it computes. For FP64 coordinates us (n, 2) and float32 v (n,), with
// d2_ij = sum_k (us[i, k] - us[j, k])^2 formed as kernel B3 forms it, y_i =
//   d2       sum_j d2_ij                       the distance only
//   d2exp32  sum_j expf(-0.5 d2_ij) v_j        the FP64 distance, then a float32
//                                              exp and a float32 accumulate
//   d2exp    sum_j exp(-0.5 d2_ij)             the distance and the FP64 exp
//   noexp    sum_j d2_ij v_j                   B3's accumulate with E := d2
//   full     sum_j exp(-0.5 d2_ij) v_j         B3 itself
// and two layouts of the same functions that ask where B3's time goes besides
// its arithmetic:
//   d2b, fullb     d2 and full with the column operands moved from shared-
//                  memory broadcast reads into registers: each lane loads one
//                  column of 32 and the warp passes them round with __shfl_sync
//                  (the TPU probe d2b asked what explicit broadcasts cost);
//   d2s2, d2s4,    d2 and full with 2 or 4 output rows per thread, so each
//   fulls2, fulls4 shared-memory read serves 2 or 4 entries (the TPU probe d2s
//                  asked about register pressure; here also the reads' share).
// Distances and exps are formed in B3's order under --fmad=false; only the
// accumulates use fma (fmaf for d2exp32), as B3 does.
//
// What bounds it. Like B3, FP64 issue: per entry 3 d operations of the
// distance, 1 to 2 of the accumulate and, where the variant has it, the scale
// and the double exp (some 32 flops as CUDA compiles it).
//
// The design is B3's (sqexp_fused.cu): 128 threads a block, one row per
// thread (or RPT rows, the thread's rows 128 apart), d = 2 fixed at compile
// time, columns staged through shared memory in tiles of 128 with v widened to
// double at staging, and the column range split over blockIdx.y so that the
// blocks fill the 132 SMs; split s writes its partial sums to partial[s] and
// the wrapper adds the splits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 128;  // threads a block (B3's ROWS)
constexpr int TJ = 128;    // columns per staged tile (B3's TJ)
constexpr int D = 2;       // coordinate dimension (df64_ablate.py d)
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Variant { D2 = 0, D2EXP32 = 1, D2EXP = 2, NOEXP = 3, FULL = 4 };

template <int V>
struct Acc { using type = double; };
template <>
struct Acc<D2EXP32> { using type = float; };

// one entry of variant V into acc, from the squared distance and v_j
template <int V, typename A>
__device__ __forceinline__ void accumulate(A& acc, double dist, double vj) {
  if constexpr (V == D2) {
    acc = acc + dist;
  } else if constexpr (V == D2EXP32) {
    acc = fmaf(expf((float)(-0.5 * dist)), (float)vj, acc);
  } else if constexpr (V == D2EXP) {
    acc = acc + exp(-0.5 * dist);
  } else if constexpr (V == NOEXP) {
    acc = fma(dist, vj, acc);
  } else {
    acc = fma(exp(-0.5 * dist), vj, acc);
  }
}

template <int RPT>
__device__ __forceinline__ void entry_distances(const double (&r)[RPT][D], double c0, double c1,
                                                double (&dist)[RPT]) {
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const double diff0 = r[q][0] - c0;
    double dd = 0.0;
    dd = dd + diff0 * diff0;
    const double diff1 = r[q][1] - c1;
    dist[q] = dd + diff1 * diff1;
  }
}

template <int V, int RPT, bool SHFL>
__global__ void __launch_bounds__(ROWS)
sqexp_ablate_kernel(const double* __restrict__ us, const float* __restrict__ v,
                    typename Acc<V>::type* __restrict__ partial, int n, int tiles_per_split) {
  using A = typename Acc<V>::type;
  __shared__ double sc[D][TJ];
  __shared__ double sv[TJ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int row[RPT];
  double r[RPT][D];
  A acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    row[q] = blockIdx.x * ROWS * RPT + q * ROWS + tid;
    const bool live = row[q] < n;
#pragma unroll
    for (int k = 0; k < D; ++k) r[q][k] = live ? us[(size_t)row[q] * D + k] : 0.0;
    acc[q] = A(0);
  }

  const int n_tiles = n / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const size_t j0 = (size_t)t * TJ;
    if constexpr (SHFL) {
      // each lane holds one column of 32; the warp passes them round
      for (int j1 = 0; j1 < TJ; j1 += 32) {
        const size_t j = j0 + j1 + lane;
        const double my0 = us[j * D], my1 = us[j * D + 1];
        const double myv = (double)v[j];
#pragma unroll 4
        for (int s = 0; s < 32; ++s) {
          const double c0 = __shfl_sync(FULL_MASK, my0, s);
          const double c1 = __shfl_sync(FULL_MASK, my1, s);
          double dist[RPT];
          entry_distances<RPT>(r, c0, c1, dist);
          const double vj = (V == NOEXP || V == FULL || V == D2EXP32)
                                ? __shfl_sync(FULL_MASK, myv, s) : 0.0;
#pragma unroll
          for (int q = 0; q < RPT; ++q) accumulate<V>(acc[q], dist[q], vj);
        }
      }
    } else {
      __syncthreads();
      for (int idx = tid; idx < TJ * D; idx += ROWS) {
        const int jj = idx / D;
        sc[idx - jj * D][jj] = us[j0 * D + idx];
      }
      if (V == NOEXP || V == FULL || V == D2EXP32) sv[tid] = (double)v[j0 + tid];
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < TJ; ++jj) {
        double dist[RPT];
        entry_distances<RPT>(r, sc[0][jj], sc[1][jj], dist);
        const double vj = (V == NOEXP || V == FULL || V == D2EXP32) ? sv[jj] : 0.0;
#pragma unroll
        for (int q = 0; q < RPT; ++q) accumulate<V>(acc[q], dist[q], vj);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    if (row[q] < n) partial[(size_t)blockIdx.y * n + row[q]] = acc[q];
}

template <int V, int RPT, bool SHFL>
int launch(const double* us, const float* v, void* partial, int n, int splits,
           cudaStream_t stream) {
  const int n_tiles = n / TJ;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((n + ROWS * RPT - 1) / (ROWS * RPT), splits);
  sqexp_ablate_kernel<V, RPT, SHFL><<<grid, ROWS, 0, stream>>>(
      us, v, static_cast<typename Acc<V>::type*>(partial), n, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// partial (splits, n) = the column splits' sums of the variant's terms, on
// `stream`; float32 for d2exp32 (variant 4), float64 for the others. variant:
// 0 d2, 1 d2b, 2 d2s2, 3 d2s4, 4 d2exp32, 5 d2exp, 6 noexp, 7 full, 8 fullb,
// 9 fulls2, 10 fulls4 (probes/df64_ablate.py VARIANTS). us (n, 2) FP64, v (n,)
// float32, n a multiple of 128. Returns the CUDA error code of the launch.
extern "C" int sqexp_ablate(const void* us, const void* v, void* partial, int n, int variant,
                            int splits, void* stream) {
  if (n < TJ || n % TJ != 0 || splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const double* u = static_cast<const double*>(us);
  const float* vv = static_cast<const float*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<D2, 1, false>(u, vv, partial, n, splits, s);
    case 1: return launch<D2, 1, true>(u, vv, partial, n, splits, s);
    case 2: return launch<D2, 2, false>(u, vv, partial, n, splits, s);
    case 3: return launch<D2, 4, false>(u, vv, partial, n, splits, s);
    case 4: return launch<D2EXP32, 1, false>(u, vv, partial, n, splits, s);
    case 5: return launch<D2EXP, 1, false>(u, vv, partial, n, splits, s);
    case 6: return launch<NOEXP, 1, false>(u, vv, partial, n, splits, s);
    case 7: return launch<FULL, 1, false>(u, vv, partial, n, splits, s);
    case 8: return launch<FULL, 1, true>(u, vv, partial, n, splits, s);
    case 9: return launch<FULL, 2, false>(u, vv, partial, n, splits, s);
    case 10: return launch<FULL, 4, false>(u, vv, partial, n, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
