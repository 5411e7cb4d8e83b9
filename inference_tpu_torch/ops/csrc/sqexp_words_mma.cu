// Probe P3: kernel B3's function with the squared distance's cross term from
// exact integer matmuls on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of benchmarks/df64_mxu_d2_experiment.py::
// _matvec_mxu_pallas (kernel :72-161, launched at :179). The plain PyTorch
// version is inference_tpu_torch/probes/df64_mxu_d2_experiment.py::
// _words_reference; the wrapper that launches this kernel is _launch_words in
// the same module.
//
// What it computes. Each coordinate is split on the host into NW = 7 integer
// words of 7 bits, u = sum_a q_a 2^(s - 7(a + 1)) with |q_a| <= 64 (s a global
// exponent from max |u|). With C_c[i, j] = sum_{a + b = c} q_a(i) . q_b(j),
// the class-c cross term, u_i . u_j = sum_{c < 7} C_c 2^(2s - 7(c + 2)) up to
// the dropped classes c >= 7 (about 1e-12 at |u| <= 10), and
//   y_i = sum_j exp(m_i + m_j + u_i . u_j) v_j,   m = -|u|^2 / 2 in FP64.
// Operands: rows_a (n, 16) int8, the words of row i word-major (a d + k) and
// zero beyond 7 d; cols_b (7, n, 16) int8, for class c and column j the words
// q_{c-a}(j) at a d + k for a <= c, zero elsewhere, so that rows_a[i] .
// cols_b[c, j] = C_c[i, j].
//
// The cross term. Every C_c is one m16n8k16 mma.sync of int8 operands with an
// int32 sum, written by hand in PTX: the words fit int8, the products are
// integers <= 4096 and every sum is exact. Of the two exact routes this one
// takes the integer tensor cores: FP64 DMMA (m8n8k4) would need 16 MMAs per
// 8 x 8 tile for the 56 products of an entry, about 5 ms at n = 53,248 at the
// FP64 tensor rate, as long as B3 takes in all; int8 needs 7 MMAs per 16 x 8
// tile (K = 7 d <= 16 fits one), under 1 ms at the int8 rate. The seven int32
// sums are then combined exactly in integers, S = sum_c C_c 2^(7(6 - c)),
// three classes at a time in 32 bits and the rest in 64 (|S| < 2^57), on the
// integer lanes; one conversion to double (to nearest, as the plain version's
// .double()) and one fma give the FP64 argument
// m_i + m_j + S 2^(2s - 56) (the product by a power of two is exact, so the fma
// rounds as the plain version's multiply and add do). B3's FP64 exp and fma
// accumulate with v widened to double follow. The TPU kernel's pair combine
// and pair exp (:120-153) worked round the TPU's lack of float64 and are not
// ported.
//
// What bounds it. The FP64 work per entry falls from B3's distance (6 flops)
// and scale to one conversion, an fma and an add, so the exp (some 32 flops)
// dominates; the tensor cores and integer lanes run beside the FP64 lanes.
//
// The design. B3's: a block of 128 rows (8 warps of 16, each warp one m16 row
// tile whose A fragments stay in registers), columns staged through shared
// memory in tiles of 128 (the 7 class vectors, the norms, v widened to
// double), the column range split over blockIdx.y. Each thread owns 4 entries
// of each 16 x 8 output tile (rows g and g + 8, columns 2 t and 2 t + 1 of
// the PTX fragment layout), accumulates its two rows, and the 4 lanes that
// share a row add their sums with shuffles at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NW = 7;        // words per coordinate (df64_mxu_d2_experiment.py NW)
constexpr int KP = 16;       // bytes of one word vector, the MMA's K
constexpr int BM = 128;      // rows a block
constexpr int TJ = 128;      // columns per staged tile
constexpr int THREADS = 256; // 8 warps of 16 rows
constexpr unsigned FULL_MASK = 0xffffffffu;

// D (16 x 8, int32) = A (16 x 16, int8, row) . B (16 x 8, int8, col). Thread
// lane = 4 g + t holds A[g][4t..4t+3] in a0, A[g + 8][4t..4t+3] in a1,
// B[4t..4t+3][g] in b, and D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// S = sum_c C_c 2^(7 (6 - c)), exact: |C_c| <= 2 (c + 1) 64^2 < 2^16, so the
// classes 4-6 and 1-3 each sum in 32 bits (< 2^30) and the rest in 64
__device__ __forceinline__ long long combine(const int (&C)[NW][4], int e) {
  const int lo = C[6][e] + C[5][e] * (1 << 7) + C[4][e] * (1 << 14);
  const int mid = C[3][e] + C[2][e] * (1 << 7) + C[1][e] * (1 << 14);
  return (long long)C[0][e] * (1LL << 42) + (long long)mid * (1LL << 21) + lo;
}

__device__ __forceinline__ void class_sums(int (&C)[NW][4], uint32_t a0, uint32_t a1,
                                           const int8_t* b_of_class, size_t class_stride) {
#pragma unroll
  for (int c = 0; c < NW; ++c)
    mma_s8(C[c], a0, a1, *reinterpret_cast<const uint32_t*>(b_of_class + c * class_stride));
}

__global__ void __launch_bounds__(THREADS)
sqexp_words_mma_kernel(const int8_t* __restrict__ rows_a, const int8_t* __restrict__ cols_b,
                       const double* __restrict__ norms, const float* __restrict__ v,
                       double scale, double* __restrict__ partial, int n, int tiles_per_split) {
  __shared__ __align__(16) int8_t sb[NW][TJ][KP];
  __shared__ double sn[TJ];
  __shared__ double sv[TJ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * BM + (tid >> 5) * 16 + g;  // the thread's rows r0, r0 + 8
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(rows_a + (size_t)r0 * KP + 4 * t4);
  const uint32_t a1 = *reinterpret_cast<const uint32_t*>(rows_a + (size_t)(r0 + 8) * KP + 4 * t4);
  const double m0 = norms[r0], m1 = norms[r0 + 8];
  double acc0 = 0.0, acc1 = 0.0;

  const int n_tiles = n / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const size_t j0 = (size_t)t * TJ;
    __syncthreads();
    for (int idx = tid; idx < NW * TJ; idx += THREADS) {
      const int c = idx / TJ, jj = idx - c * TJ;
      *reinterpret_cast<int4*>(&sb[c][jj][0]) =
          *reinterpret_cast<const int4*>(cols_b + ((size_t)c * n + j0 + jj) * KP);
    }
    if (tid < TJ) {
      sn[tid] = norms[j0 + tid];
      sv[tid] = (double)v[j0 + tid];
    }
    __syncthreads();
#pragma unroll 1
    for (int nt = 0; nt < TJ / 8; ++nt) {
      int C[NW][4];
      class_sums(C, a0, a1, &sb[0][nt * 8 + g][4 * t4], TJ * KP);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = nt * 8 + 2 * t4 + (e & 1);
        const double cross = (double)combine(C, e);
        const double arg = fma(cross, scale, (e < 2 ? m0 : m1) + sn[jj]);
        const double E = exp(arg);
        if (e < 2) acc0 = fma(E, sv[jj], acc0);
        else acc1 = fma(E, sv[jj], acc1);
      }
    }
  }
  acc0 += __shfl_xor_sync(FULL_MASK, acc0, 1);
  acc0 += __shfl_xor_sync(FULL_MASK, acc0, 2);
  acc1 += __shfl_xor_sync(FULL_MASK, acc1, 1);
  acc1 += __shfl_xor_sync(FULL_MASK, acc1, 2);
  if (t4 == 0) {
    partial[(size_t)blockIdx.y * n + r0] = acc0;
    partial[(size_t)blockIdx.y * n + r0 + 8] = acc1;
  }
}

// one warp: the 7 class sums of rows 0-15 and columns 0-7, out (7, 16, 8)
__global__ void words_mma_tile_kernel(const int8_t* __restrict__ rows_a,
                                      const int8_t* __restrict__ cols_b, int* __restrict__ out,
                                      int n) {
  const int lane = threadIdx.x, g = lane >> 2, t4 = lane & 3;
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(rows_a + g * KP + 4 * t4);
  const uint32_t a1 = *reinterpret_cast<const uint32_t*>(rows_a + (g + 8) * KP + 4 * t4);
  int C[NW][4];
  class_sums(C, a0, a1, cols_b + g * KP + 4 * t4, (size_t)n * KP);
  for (int c = 0; c < NW; ++c)
    for (int e = 0; e < 4; ++e)
      out[(c * 16 + g + 8 * (e >> 1)) * 8 + 2 * t4 + (e & 1)] = C[c][e];
}

}  // namespace

// partial (splits, n) = the column splits' sums of exp(m_i + m_j + S_ij
// 2^shift) v_j, on `stream`, with rows_a (n, 16) and cols_b (7, n, 16) int8,
// norms (n,) FP64, v (n,) float32; n a multiple of 128. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int sqexp_words_mma(const void* rows_a, const void* cols_b, const void* norms,
                               const void* v, void* partial, int shift, int n, int splits,
                               void* stream) {
  if (n < TJ || n % TJ != 0 || splits < 1 || splits > 65535 || shift < -1000 || shift > 1000)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n / TJ;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid(n / BM, splits);
  sqexp_words_mma_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows_a), static_cast<const int8_t*>(cols_b),
      static_cast<const double*>(norms), static_cast<const float*>(v), ldexp(1.0, shift),
      static_cast<double*>(partial), n, tiles_per_split);
  return (int)cudaGetLastError();
}

// out (7, 16, 8) int32 = the class sums C_c of rows 0-15 and columns 0-7, by
// one warp of the same MMAs: the fragment layout's check.
extern "C" int words_mma_tile(const void* rows_a, const void* cols_b, void* out, int n,
                              void* stream) {
  if (n < 16) return (int)cudaErrorInvalidValue;
  words_mma_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows_a), static_cast<const int8_t*>(cols_b),
      static_cast<int*>(out), n);
  return (int)cudaGetLastError();
}
