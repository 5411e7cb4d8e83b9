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
// predicated loop can issue more FP64 work than the entry itself.
//
// Above d = 16 (sqexp_entries_wide_kernel) FP64 issue bounds both: 3 d + 1
// operations, the exp's ~18 per entry, 79 at d = 20 (13.4 ms of issue at n =
// 53,248 on 132 SMs x 64 lanes x 1.98 GHz, each sub, mul and add a whole
// FP64 instruction, as bit-for-bit agreement with the plain version
// demands), against B5's 6.8 ms store. What the design does about it:
// - Each thread keeps the partial distances of its 16 consecutive rows by 2
//   columns in registers; per dimension it reads its two columns as one
//   16-byte load and its rows as 8 broadcast 16-byte loads, for 96 FP64
//   instructions.
// - A tile's 64 rows and 128 columns are staged by cp.async into shared
//   memory as [k][point], consecutive threads on consecutive device
//   addresses (each warp load coalesced), the row stride padded by two
//   doubles so that the transposing writes spread over the banks. d is
//   zero-padded to a multiple of 4 in the copy, since adding (0 - 0)^2 = +0
//   leaves a distance bit for bit, and the unrolled k loop has no
//   predicate. Up to 32 dimensions go in one pass; beyond, chunks of 32
//   follow one another and the distances stay in registers between them.
// - A persistent walk: a grid of as many blocks as fit on the SMs (two or
//   more each) walks the output tiles, and each (tile, chunk) unit's copy
//   is double buffered: unit u + 1's coordinates are in flight while unit u
//   is computed, so one tile's exps and streaming stores overlap the next
//   tile's copy, with one barrier per unit.
// On the H100 it runs at about 1.3x its issue time at d = 20: the distance
// loop at about 1.2x its FP64 time, the streaming stores about 1 ms beside
// it (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int TR = 64;               // tile rows
constexpr int TX = 64;               // threads across a tile, two columns each
constexpr int TC = 2 * TX;           // tile columns (df64.py _TJ)
constexpr int TY = 4;                // threads down a tile
constexpr int THREADS = TX * TY;     // 256
constexpr int D_MAX = 16;            // df64.py D_MAX

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

// cp.async of 8 bytes from device to shared memory, through the L1
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int PTS = TR + TC;  // points of a tile: its rows, then its columns
// row stride of the staged [k][point] copy: even, for 16-byte reads, and
// 2 doubles past PTS, so that the copy's writes (consecutive threads on
// consecutive k) spread over 8 bank pairs
constexpr int PTS_PAD = PTS + 2;
constexpr int WKC = 32;       // dimensions staged per unit above D_MAX

// d > D_MAX (see the header): a persistent walk over the (n / TR) x (n / TC)
// output tiles, each in ceil(d_pad / WKC) units of up to WKC dimensions.
// Dynamic shared memory: two buffers of [min(d_pad, WKC)][PTS_PAD] doubles.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sqexp_entries_wide_kernel(const double* __restrict__ us, T* __restrict__ out, int n, int d,
                          int d_pad) {
  extern __shared__ __align__(16) double sp[];
  const int kc_max = min(d_pad, WKC);
  const int n_chunks = (d_pad + WKC - 1) / WKC;
  const int col_tiles = n / TC;
  const int n_tiles = (n / TR) * col_tiles;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int units = blockIdx.x < n_tiles
                        ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x * n_chunks + n_chunks
                        : 0;

  // copy unit u's coordinates into buffer b as [k][point] with row stride
  // PTS_PAD, consecutive threads on consecutive device addresses (a point's
  // dimensions, then the next point's); zeros in the pad dimensions
  auto stage = [&](int u, int b) {
    const int t = blockIdx.x + (u / n_chunks) * gridDim.x;
    const int k0 = (u % n_chunks) * WKC;
    const int kc = min(WKC, d_pad - k0), kr = min(kc, d - k0);  // staged, real
    const int row0 = t / col_tiles * TR, col0 = t % col_tiles * TC;
    double* dst = sp + (size_t)b * kc_max * PTS_PAD;
    const int step_p = THREADS / kr, step_k = THREADS - step_p * kr;
    int p = tid / kr, k = tid - p * kr;
    for (int idx = tid; idx < PTS * kr; idx += THREADS) {
      const int point = p < TR ? row0 + p : col0 + p - TR;
      cp_async8(dst + k * PTS_PAD + p, us + (size_t)point * d + k0 + k);
      k += step_k;
      p += step_p;
      if (k >= kr) {
        k -= kr;
        ++p;
      }
    }
    for (int idx = tid; idx < PTS * (kc - kr); idx += THREADS)
      dst[(kr + idx / PTS) * PTS_PAD + idx % PTS] = 0.0;
    cp_async_commit();
  };

  const int r0 = threadIdx.y * (TR / TY);  // the thread's 16 consecutive rows
  const int c = TR + 2 * threadIdx.x;      // its two columns, in the tile's points
  double d0[TR / TY], d1[TR / TY];
  if (units > 0) stage(0, 0);
  for (int u = 0; u < units; ++u) {
    const int b = u & 1;
    cp_async_wait_all();
    __syncthreads();  // unit u staged; every thread done with unit u - 1
    if (u + 1 < units) stage(u + 1, b ^ 1);
    const int chunk = u % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < TR / TY; ++i) d0[i] = d1[i] = 0.0;
    }
    const double* s = sp + (size_t)b * kc_max * PTS_PAD;
    const int kc = min(WKC, d_pad - chunk * WKC);
    for (int k = 0; k < kc; k += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const double* sk = s + (k + kk) * PTS_PAD;
        const double2 cc = *reinterpret_cast<const double2*>(sk + c);
#pragma unroll
        for (int i = 0; i < TR / TY; i += 2) {
          const double2 a = *reinterpret_cast<const double2*>(sk + r0 + i);
          const double e00 = a.x - cc.x, e01 = a.x - cc.y;
          const double e10 = a.y - cc.x, e11 = a.y - cc.y;
          d0[i] = d0[i] + e00 * e00;
          d1[i] = d1[i] + e01 * e01;
          d0[i + 1] = d0[i + 1] + e10 * e10;
          d1[i + 1] = d1[i + 1] + e11 * e11;
        }
      }
    }
    if (chunk == n_chunks - 1) {
      const int t = blockIdx.x + (u / n_chunks) * gridDim.x;
      T* o = out + (size_t)(t / col_tiles * TR + r0) * n + t % col_tiles * TC + 2 * threadIdx.x;
#pragma unroll
      for (int i = 0; i < TR / TY; ++i) {
        typename Two<T>::type val;
        val.x = static_cast<T>(exp(-0.5 * d0[i]));
        val.y = static_cast<T>(exp(-0.5 * d1[i]));
        __stcs(reinterpret_cast<typename Two<T>::type*>(o + (size_t)i * n), val);
      }
    }
  }
}

// DT < 0: the wide kernel, persistent: as many blocks as fit on the SMs
template <typename T, int DT>
int launch(const double* us, T* out, int n, int d, cudaStream_t stream) {
  dim3 block(TX, TY);
  if constexpr (DT < 0) {
    const int d_pad = (d + 3) / 4 * 4;
    const int smem = 2 * min(d_pad, WKC) * PTS_PAD * (int)sizeof(double);
    auto kernel = sqexp_entries_wide_kernel<T>;
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int device = 0, sms = 0, per_sm = 0;
    if (rc == cudaSuccess) rc = cudaGetDevice(&device);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (rc != cudaSuccess) return (int)rc;
    const long n_tiles = (long)(n / TR) * (n / TC);
    const int grid = (int)std::min<long>(n_tiles, (long)sms * std::max(per_sm, 1));
    kernel<<<grid, block, smem, stream>>>(us, out, n, d, d_pad);
  } else {
    dim3 grid(n / TC, n / TR);
    sqexp_entries_kernel<T, DT><<<grid, block, 0, stream>>>(us, out, n, d);
  }
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
