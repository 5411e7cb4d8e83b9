// Kernels B5 and B7: the squared-exponential entry store, in native FP64 and
// rounded to float32, for Hopper (sm_90a).
//
// B5 replaces inference_tpu/ops/df64.py::_entries_kernel (launched by
// _sqexp_entries_df64_pallas), which wrote the entries as an (n, n) pair of
// float32 words because the TPU has no float64. Here the store is one FP64
// (n, n) matrix: 8 bytes per entry, as the pair was. B7 replaces
// _entries_f32_kernel (launched by _sqexp_entries_f32_pallas), which wrote the
// pair-accurate entry rounded to one float32 word: here the FP64 entry rounded
// to nearest, 4 bytes per entry. The plain PyTorch versions are
// inference_tpu_torch/ops/df64.py::_entries_reference (B5) and
// _entries_f32_reference (B7); the wrappers that launch them are
// _launch_entries and _launch_entries_f32 in the same module.
//
// What it computes. For pre-scaled FP64 coordinates us (n, d), row-major:
//   out[i, j] = T(exp(-0.5 * sum_k (us[i, k] - us[j, k])^2))
// with T double (B5) or float (B7, round to nearest), dist = dist + diff * diff
// over k in order (the build uses --fmad=false), then the accurate exp: the
// plain version's separate torch operations in the same order, so the two agree
// bit for bit on the card. It is kernel B2 (csrc/sqexp.cu) with A = 1 and the
// dimension fixed at compile time. The matrix is symmetric, but the kernel
// writes it whole: kernels B6 and B8 then read rows, never columns.
//
// What bounds it on this card. B5: the store, 22.7 GB at n = 53,248, 6.8 ms at
// 3.35 TB/s. The arithmetic is 3 d + 1 operations and CUDA's double exp (some
// eighteen FP64 instructions) per entry, about 3.3 ms of FP64 issue at d = 2,
// so B5 should sit at the store bound if the FP64 work hides under it. B7
// stores half the bytes (11.3 GB, 3.4 ms) and does the same FP64 work, so its
// two bounds are about equal and it can reach neither unless the two overlap
// completely.
//
// What the design does about it. A block writes a 64 x 128 tile with 256
// threads: each thread owns two adjacent columns and 16 rows, so every store
// is one double2 (B5) or float2 (B7), a warp's store one contiguous 512- or
// 256-byte run, and the stores are streaming (__stcs: the matrix is far larger
// than the 50 MB L2). The tile's rows are staged in shared memory, read as
// broadcasts; a thread keeps its two columns' coordinates in registers. The
// dimension is a template parameter for d <= 3: with a runtime d, a D_MAX-long
// predicated loop can issue more FP64 work than the entry itself. Above d = 16
// a thread keeps its 32 entries' partial distances in registers instead, and
// the tile's rows and columns pass through shared memory in chunks of KC
// dimensions: the same sums in the same order, for any d.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TR = 64;               // tile rows
constexpr int TX = 64;               // threads across a tile, two columns each
constexpr int TC = 2 * TX;           // tile columns (df64.py _TJ)
constexpr int TY = 4;                // threads down a tile
constexpr int THREADS = TX * TY;     // 256
constexpr int D_MAX = 16;            // df64.py D_MAX
constexpr int KC = 16;               // dimensions per staged chunk above D_MAX

template <typename T> struct Two;
template <> struct Two<double> { using type = double2; };
template <> struct Two<float> { using type = float2; };

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
sqexp_entries_kernel(const double* __restrict__ us, T* __restrict__ out, int n,
                     int d_runtime) {
  constexpr int DM = DT > 0 ? DT : D_MAX;
  const int d = DT > 0 ? DT : d_runtime;
  __shared__ double su[DM][TR];

  const int row0 = blockIdx.y * TR;
  const int col = blockIdx.x * TC + 2 * threadIdx.x;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int idx = tid; idx < TR * d; idx += THREADS) {
    const int r = idx / d;
    const int k = idx - r * d;
    su[k][r] = us[(size_t)(row0 + r) * d + k];
  }
  double c0[DM], c1[DM];
#pragma unroll
  for (int k = 0; k < DM; ++k) {
    c0[k] = (DT > 0 || k < d) ? us[(size_t)col * d + k] : 0.0;
    c1[k] = (DT > 0 || k < d) ? us[(size_t)(col + 1) * d + k] : 0.0;
  }
  __syncthreads();

#pragma unroll 4
  for (int i = 0; i < TR / TY; ++i) {
    const int r = threadIdx.y + i * TY;
    double d0 = 0.0, d1 = 0.0;
#pragma unroll
    for (int k = 0; k < DM; ++k) {
      if (DT > 0 || k < d) {
        const double a = su[k][r];
        const double e0 = a - c0[k];
        const double e1 = a - c1[k];
        d0 = d0 + e0 * e0;
        d1 = d1 + e1 * e1;
      }
    }
    typename Two<T>::type val;
    val.x = static_cast<T>(exp(-0.5 * d0));
    val.y = static_cast<T>(exp(-0.5 * d1));
    __stcs(reinterpret_cast<typename Two<T>::type*>(out + (size_t)(row0 + r) * n + col), val);
  }
}

// d > D_MAX: the partial distances of the thread's 16 rows by 2 columns in
// registers, the coordinates staged KC dimensions at a time
template <typename T>
__global__ void __launch_bounds__(THREADS)
sqexp_entries_wide_kernel(const double* __restrict__ us, T* __restrict__ out, int n, int d) {
  __shared__ double su[KC][TR];
  __shared__ double sc[KC][TC];

  const int row0 = blockIdx.y * TR;
  const int col0 = blockIdx.x * TC;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int c = 2 * threadIdx.x;

  double d0[TR / TY], d1[TR / TY];
#pragma unroll
  for (int i = 0; i < TR / TY; ++i) d0[i] = d1[i] = 0.0;
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kc = min(KC, d - k0);
    __syncthreads();
    for (int idx = tid; idx < TR * kc; idx += THREADS) {
      const int r = idx / kc;
      su[idx - r * kc][r] = us[(size_t)(row0 + r) * d + k0 + idx - r * kc];
    }
    for (int idx = tid; idx < TC * kc; idx += THREADS) {
      const int j = idx / kc;
      sc[idx - j * kc][j] = us[(size_t)(col0 + j) * d + k0 + idx - j * kc];
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const double b0 = sc[k][c], b1 = sc[k][c + 1];
#pragma unroll
      for (int i = 0; i < TR / TY; ++i) {
        const double a = su[k][threadIdx.y + i * TY];
        const double e0 = a - b0;
        const double e1 = a - b1;
        d0[i] = d0[i] + e0 * e0;
        d1[i] = d1[i] + e1 * e1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR / TY; ++i) {
    typename Two<T>::type val;
    val.x = static_cast<T>(exp(-0.5 * d0[i]));
    val.y = static_cast<T>(exp(-0.5 * d1[i]));
    __stcs(reinterpret_cast<typename Two<T>::type*>(
               out + (size_t)(row0 + threadIdx.y + i * TY) * n + col0 + c),
           val);
  }
}

// DT < 0: the wide kernel
template <typename T, int DT>
int launch(const double* us, T* out, int n, int d, cudaStream_t stream) {
  dim3 grid(n / TC, n / TR);
  dim3 block(TX, TY);
  if constexpr (DT < 0)
    sqexp_entries_wide_kernel<T><<<grid, block, 0, stream>>>(us, out, n, d);
  else
    sqexp_entries_kernel<T, DT><<<grid, block, 0, stream>>>(us, out, n, d);
  return (int)cudaGetLastError();
}

template <typename T>
int entries(const void* us, void* out, int n, int d, void* stream) {
  if (n < TC || n % TC != 0 || n / TR > 65535 || d < 1) return (int)cudaErrorInvalidValue;
  const double* u = static_cast<const double*>(us);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<T, 1>(u, o, n, d, s);
    case 2: return launch<T, 2>(u, o, n, d, s);
    case 3: return launch<T, 3>(u, o, n, d, s);
    default: return d <= D_MAX ? launch<T, 0>(u, o, n, d, s) : launch<T, -1>(u, o, n, d, s);
  }
}

}  // namespace

// Kernel B5: out (n, n) FP64 = exp(-0.5 |us_i - us_j|^2), on `stream`. n must
// be a positive multiple of 128 and d >= 1. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int sqexp_entries_f64(const void* us, void* out, int n, int d, void* stream) {
  return entries<double>(us, out, n, d, stream);
}

// Kernel B7: the same entries rounded to float32, out (n, n) float32.
extern "C" int sqexp_entries_f32(const void* us, void* out, int n, int d, void* stream) {
  return entries<float>(us, out, n, d, stream);
}
