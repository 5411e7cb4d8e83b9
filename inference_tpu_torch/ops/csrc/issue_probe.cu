// Probe P1: the multiply/add issue rate of the CUDA cores in float and double,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel of benchmarks/vpu_probe.py::main (kernel body
// :37-63, launched at :78), which measured the TPU's vector-unit issue rate.
// The plain PyTorch version is inference_tpu_torch/probes/vpu_probe.py::
// _probe_reference; the wrapper that launches this kernel is _launch_probe in
// the same module.
//
// What it computes. For a (128, 128) tile x and each of n_chains chains c:
//   y_c = x * T(1 + 1e-6 c), then n_ops / 2 times: y_c = y_c * a; y_c = y_c + b
//   out = ((y_0 + y_1) + y_2) + ...
// with the operands a and b of the mode:
//   scalar     a = T(0.9999999), b = T(1e-7), constants;
//   vv         a = x * T(0.9999999), b = x * T(1e-9), per element, in registers;
//   bcast      a = x[row, 0] * T(1e-9) + T(0.9999999) per row, read from shared
//              memory at every multiply round by all threads of the block at
//              one address (the broadcast read kernel B3 makes for every
//              column coordinate); b = x[0, col] * T(1e-9) per column, in a
//              register;
//   bcast_mat  the same a read from a shared-memory matrix, at a different
//              address for every thread (the counterpart of the VMEM
//              scratch), at every multiply round; b as in bcast.
// Every multiply and add is __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn), so no
// pair is contracted into an FMA whatever the build's --fmad: the instruction
// mix is the probe's and the result equals the plain version's bit for bit.
//
// What bounds it. The reps copies of the tile (the TPU's grid of 512 steps)
// issue reps * 128^2 * n_chains * n_ops multiplies and adds and read and write
// one tile, so it is bound by issue: 132 SMs x 128 FP32 lanes (64 FP64 lanes)
// x the SM clock. With one chain each thread waits on its own result; more
// chains give each warp independent instructions to issue.
//
// The design. One block of 128 threads is one row of one copy of the tile
// (thread = column, so loads are coalesced and a per-row operand is uniform in
// the block: a shared-memory read of it is a broadcast), and reps * 128 blocks
// fill the 132 SMs many times over, as the TPU grid amortised its launch. Only
// the first copy stores its result; an empty volatile asm that takes every
// copy's result keeps the compiler from dropping the others' work.

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;  // the tile's side (vpu_probe.py T)

enum Mode { SCALAR = 0, VV = 1, BCAST = 2, BCAST_MAT = 3 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// the value must be computed: an empty volatile asm takes it
__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }
__device__ __forceinline__ void keep(double v) { asm volatile("" ::"d"(v)); }

template <typename F, int MODE, int NCH>
__global__ void __launch_bounds__(T)
issue_probe_kernel(const F* __restrict__ x, F* __restrict__ out, int half) {
  __shared__ F s_a[T];  // bcast_mat: the row of the operand matrix
  __shared__ F s_r;     // bcast: the row's operand
  const int col = threadIdx.x;
  const int row = blockIdx.x % T;
  const F c_mul = static_cast<F>(0.9999999);
  const F c_add = static_cast<F>(1e-7);
  const F c_small = static_cast<F>(1e-9);
  const F xv = x[row * T + col];

  F a = c_mul, b = c_add;
  if (MODE == VV) {
    a = mul_rn(xv, c_mul);
    b = mul_rn(xv, c_small);
  } else if (MODE == BCAST || MODE == BCAST_MAT) {
    a = add_rn(mul_rn(x[row * T], c_small), c_mul);
    b = mul_rn(x[col], c_small);
    if (MODE == BCAST_MAT) s_a[col] = a;
    if (MODE == BCAST && col == 0) s_r = a;
    __syncthreads();
  }
  volatile F* va = MODE == BCAST ? &s_r : s_a + col;

  F y[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) y[c] = mul_rn(xv, static_cast<F>(1.0 + 1e-6 * c));
#pragma unroll 4
  for (int i = 0; i < half; ++i) {
    const F ai = (MODE == BCAST || MODE == BCAST_MAT) ? *va : a;
#pragma unroll
    for (int c = 0; c < NCH; ++c) y[c] = mul_rn(y[c], ai);
#pragma unroll
    for (int c = 0; c < NCH; ++c) y[c] = add_rn(y[c], b);
  }
  F acc = y[0];
#pragma unroll
  for (int c = 1; c < NCH; ++c) acc = add_rn(acc, y[c]);
  keep(acc);
  if (blockIdx.x < T) out[row * T + col] = acc;
}

template <typename F, int MODE>
int launch_mode(const F* x, F* out, int half, int n_chains, int reps, cudaStream_t s) {
  const dim3 grid(reps * T);
  switch (n_chains) {
    case 1: issue_probe_kernel<F, MODE, 1><<<grid, T, 0, s>>>(x, out, half); break;
    case 2: issue_probe_kernel<F, MODE, 2><<<grid, T, 0, s>>>(x, out, half); break;
    case 4: issue_probe_kernel<F, MODE, 4><<<grid, T, 0, s>>>(x, out, half); break;
    default: issue_probe_kernel<F, MODE, 8><<<grid, T, 0, s>>>(x, out, half); break;
  }
  return (int)cudaGetLastError();
}

template <typename F>
int launch(const void* x, void* out, int n_ops, int mode, int n_chains, int reps, void* stream) {
  if (n_ops < 0 || mode < 0 || mode > 3 || reps < 1 || reps > (1 << 23) ||
      (n_chains != 1 && n_chains != 2 && n_chains != 4 && n_chains != 8))
    return (int)cudaErrorInvalidValue;
  const F* xp = static_cast<const F*>(x);
  F* op = static_cast<F*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int half = n_ops / 2;
  switch (mode) {
    case SCALAR: return launch_mode<F, SCALAR>(xp, op, half, n_chains, reps, s);
    case VV: return launch_mode<F, VV>(xp, op, half, n_chains, reps, s);
    case BCAST: return launch_mode<F, BCAST>(xp, op, half, n_chains, reps, s);
    default: return launch_mode<F, BCAST_MAT>(xp, op, half, n_chains, reps, s);
  }
}

}  // namespace

// out (128, 128) = the probe's chains on the tile x (128, 128), computed by
// reps copies of the tile at once, on `stream`. mode: 0 scalar, 1 vv, 2 bcast,
// 3 bcast_mat; n_chains 1, 2, 4 or 8. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int issue_probe_f32(const void* x, void* out, int n_ops, int mode, int n_chains,
                               int reps, void* stream) {
  return launch<float>(x, out, n_ops, mode, n_chains, reps, stream);
}

extern "C" int issue_probe_f64(const void* x, void* out, int n_ops, int mode, int n_chains,
                               int reps, void* stream) {
  return launch<double>(x, out, n_ops, mode, n_chains, reps, stream);
}
