// Kernel B1: fused whole-trajectory HMC transitions, written for Hopper (sm_90a).
//
// Replaces inference_tpu/ops/hmc_fused.py::_make_chunk_kernel, the Pallas
// kernel that inference_tpu/ops/hmc_fused.py::_run_chunk launches. Its plain
// PyTorch version is inference_tpu_torch/ops/hmc_fused.py::_reference_chunk,
// and the wrapper that launches it is _launch_chunk in the same module.
//
// What it computes. For every chain k, `chunk` duplicate-on-reject HMC
// transitions on the Gaussian form logp(t) = -1/2 (t-mu)^T A (t-mu) (A is
// symmetric), each one:
//   r0 = z / sqrt(im); n = clamp(int(steps * (1 + (u_s - 0.5) * 0.2)), 1, max_steps);
//   a half kick with inv_temp * eps * grad, n drifts and kicks (the last
//   kick halved); p = logp(t) * inv_temp; accept_prob = exp(h0 - h);
//   the step-size adaptation of mcmc/_kernels/common.py::submit_accept_prob;
//   accept when accept_prob >= 1 or u_a <= accept_prob.
// With history pointers it also writes (theta, logp, n, eps) per transition.
// Layout is (P, K): thread k reads column k, so a warp reads 32 neighbouring
// floats of each row.
//
// What bounds it on this card. A transition streams 4*P bytes of normals and
// 8 bytes of uniforms per chain; the state never leaves the chip within a
// chunk. Against that it does about 50 * (2 P^2 + 5 P) flops of matvec and
// integrator work (about 13 kFLOP at P = 10, some 250 flops per byte), far
// above the card's FP32-to-HBM ratio of about 20. So the kernel is bound by
// its instruction issue, and every instruction of the leapfrog step that is
// not a multiply or add of the step's own arithmetic is a loss.
//
// What the design does about it. The library is built once per parameter
// count, P = B1_P, and kind of mass, B1_UNIT (1: unit, 0: diagonal), so
// every loop over P unrolls completely, without guards or padded columns,
// every register array has constant indices, and unit mass skips the
// multiplies by 1; a program builds only the kernels it launches. One
// thread per chain keeps its proposal, momentum and centred position (3 P
// floats) in registers through every leapfrog step of every transition in
// the chunk; the current position, needed only to restore it on a
// rejection, waits in shared memory. The form (A, mu, the diagonal inverse
// mass) is uniform over the grid and travels in the kernel's parameters (a
// __grid_constant__ struct of at most 16.9 KB, at P = 64), which the
// launcher fills from host copies: every launch carries its own form, so
// launches on any stream share no state. Where the matvec reads A was
// chosen by timing both places on the H100 (PERF.md, B1 findings):
//   P <= 12: from the parameters' constant bank. The assembler holds A's
//     P^2 values in uniform and regular registers through the loop, so a
//     leapfrog step is its multiplies and adds and a few loop instructions,
//     with no load;
//   P > 12: from shared memory as float4 broadcasts (one LDS.128 for four
//     FFMA), staged from the parameters once per block, because A no longer
//     fits the register file beside the state, and the assembler's hoisting
//     of constant-bank values then spills.
// Each value is loaded inside the loop by a volatile load, so the
// compiler's front end cannot hoist all of A out of the loop first. The
// quadratic form is evaluated once, after the last step.
//
// Rounding. Built with --fmad=false, so no multiply and add are contracted
// behind the code's back: the step count, the energies and the adaptation
// round as the plain version's separate torch operations do. Only the matvec
// accumulation uses explicit fmaf, as the plain version's matmul does, and
// the quadratic form after the last step repeats the last kick's products
// in the same order, so one transition matches the plain version bit for
// bit.
//
// The wide route, P > 64 (built once, with -DB1_P=0, for any P and either
// kind of mass; P is a launch argument). Neither of the above scales: at
// P = 128 one thread would hold 384 state floats, and A (4 P^2 bytes) no
// longer fits a block's shared memory from P = 239. So one warp owns one
// chain: its position, momentum, centred position and current position
// (4 P floats, rows padded to P4 = a multiple of 4) live in the warp's
// share of shared memory, and lane l owns the groups of four rows q = l,
// l + 32, ... of every elementwise step and of the gradient matvec. A is
// read from device memory, where the launcher keeps a zero-padded P4 x P4
// copy, through L1 and L2 (40 KB at P = 100 stays in L1; 256 KB at P = 256
// streams from L2): since A is symmetric, (A d)_i = sum_j A[j][i] d_j, so
// the 32 lanes read row j of A as 32 neighbouring float4s while d_j is a
// shared-memory broadcast. Each step the warp reads all of A, so at large
// P the kernel is bound by the L2's bandwidth, not by its flops: a simple
// design that is right, to be made fast later. The matvec accumulates over
// j in order with fmaf as above; the kinetic sums and the quadratic form
// (taken from the last kick's own matvec) are summed per lane and then
// across the warp by a butterfly, so every lane holds the same bits and
// the chain's branches stay uniform. Those sums round in another order
// than the plain version's, so the wide route agrees with it within the
// float32 tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>
#include <utility>

#if !defined(B1_P) || (B1_P > 0 && !defined(B1_UNIT))
#error "kernel B1 is built per parameter count and mass: nvcc -DB1_P=<1..64> -DB1_UNIT=<0|1>, or -DB1_P=0 for the wide route"
#endif

namespace {

// step-size adaptation constants (mcmc/_kernels/hmc.py EPS_*)
constexpr float EPS_TARGET = 0.65f;
constexpr float EPS_GROWTH = 1.4f;
constexpr float EPS_VAR_FLOOR = 0.03f;
constexpr float EPS_POWER = 0.15f;
constexpr float EPS_MIN_ADJ = 0.5f;
constexpr float EPS_MAX_ADJ = 2.0f;

// One transition's step-size adaptation (submit_accept_prob) from the
// acceptance probability ap, on the chain's (value, avg, var, num, chk_int).
__device__ __forceinline__ void adapt(float ap, float& ev, float& ea, float& evr, int& en,
                                      int& ec) {
  const float sub = isfinite(ap) ? fminf(ap, 1.0f) : 0.0f;
  en = en + 1;
  ea = ea + sub;
  evr = evr + fmaxf(sub * (1.0f - sub), EPS_VAR_FLOOR);
  const bool due = en >= ec;
  const float denom = fmaxf(static_cast<float>(en), 1.0f);
  const float mu = due ? ea / denom : 0.5f;
  const float sd = sqrtf(fmaxf(evr, 0.0f)) / denom;
  const bool in_band = (mu - 2.0f * sd < EPS_TARGET) && (EPS_TARGET < mu + 2.0f * sd);
  if (due && !in_band) {
    // mu is clipped to [1e-12, 1 - 1e-12], whose upper end rounds to 1.0f
    const float mu_safe = fminf(fmaxf(mu, 1e-12f), 1.0f);
    const float ratio = logf(EPS_TARGET) / logf(mu_safe);
    const float adj = fminf(fmaxf(powf(ratio, EPS_POWER), EPS_MIN_ADJ), EPS_MAX_ADJ);
    ev = ev * adj;
    ea = 0.0f;
    evr = 0.0f;
    en = 0;
  } else if (due) {
    ec = static_cast<int>(floorf(EPS_GROWTH * static_cast<float>(ec) * 0.1f)) * 10;
  }
}

// the jittered step count of one transition, at least one drift
__device__ __forceinline__ int step_count(float u, int steps, int max_steps) {
  const int n = static_cast<int>(static_cast<float>(steps) * (1.0f + (u - 0.5f) * 0.2f));
  return max(min(n, max_steps), 1);
}

}  // namespace

#if B1_P > 0

constexpr int P = B1_P;
constexpr bool UNIT = B1_UNIT != 0;  // unit mass, else diagonal
static_assert(P >= 1 && P <= 64, "kernel B1 takes 1 to 64 parameters");

constexpr int MU = P * P;  // offsets of mu and the inverse mass in Args::form
constexpr int IM = P * P + P;

struct Args {
  // state in
  const float* theta;     // (P, K)
  const float* logp;      // (K,)
  const float* ev;        // (K,) eps.value
  const float* ea;        // (K,) eps.avg
  const float* evr;       // (K,) eps.var
  const int* en;          // (K,) eps.num
  const int* ec;          // (K,) eps.chk_int
  const float* inv_temp;  // (K,)
  // random operands
  const float* z;         // (chunk, P, K) standard normals
  const float* us;        // (chunk, K) step-count uniforms
  const float* ua;        // (chunk, K) accept uniforms
  // state out
  float* theta_o;
  float* logp_o;
  float* ev_o;
  float* ea_o;
  float* evr_o;
  int* en_o;
  int* ec_o;
  // history out, all null without store
  float* h_theta;         // (chunk, P, K)
  float* h_logp;          // (chunk, K)
  int* h_steps;           // (chunk, K)
  float* h_eps;           // (chunk, K)
  int K, chunk, steps, max_steps;
  // the form: A (P x P, row major), mu (P), the diagonal inverse mass (P,
  // unread with unit mass)
  float form[P * P + 2 * P];
};

namespace {

constexpr bool SHARED_A = P > 12;    // where the matvec reads A (see above)
constexpr int P4 = (P + 3) / 4 * 4;  // a row of A in shared memory, zero padded
constexpr int BLOCK = 128;           // 64 and 256 measured no faster at P = 10 and 32
using Cols = std::make_integer_sequence<int, P>;
using Groups = std::make_integer_sequence<int, P4 / 4>;

// Args::form[IDX] of the kernel's parameter, by a volatile load that the
// compiler's front end keeps where it is used (a plain read of the form in
// the constant bank was hoisted out of the leapfrog loop and ran 1.29x
// slower at P = 10, PERF.md). The kernel is extern "C", so its parameter's
// PTX name is hmc_chunk_kernel_param_0.
template <int IDX>
__device__ __forceinline__ float form() {
  float v;
  asm volatile("ld.param.f32 %0, [hmc_chunk_kernel_param_0+%1];"
               : "=f"(v) : "n"(offsetof(Args, form) + 4 * IDX));
  return v;
}

// (A d)_I, accumulated in column order with fmaf from 0, as the plain
// version's matmul rounds it
template <int I, int... J>
__device__ __forceinline__ float row_dot(uint32_t, const float (&d)[P],
                                         std::integer_sequence<int, J...>) {
  float acc = 0.0f;
  ((acc = fmaf(form<I * P + J>(), d[J], acc)), ...);
  return acc;
}

// the same from A in shared memory (at the shared address a_s), four
// columns per load
template <int I, int... G>
__device__ __forceinline__ float row_dot_shared(uint32_t a_s, const float (&d)[P],
                                                std::integer_sequence<int, G...>) {
  float acc = 0.0f;
  auto group = [&](auto g) {
    constexpr int j = 4 * decltype(g)::value;
    float x, y, z, w;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+%5];"
                 : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(a_s), "n"(4 * (I * P4 + j)));
    acc = fmaf(x, d[j], acc);
    if constexpr (j + 1 < P) acc = fmaf(y, d[j + 1], acc);
    if constexpr (j + 2 < P) acc = fmaf(z, d[j + 2], acc);
    if constexpr (j + 3 < P) acc = fmaf(w, d[j + 3], acc);
  };
  (group(std::integral_constant<int, G>{}), ...);
  return acc;
}

template <int I>
__device__ __forceinline__ float row(uint32_t a_s, const float (&d)[P]) {
  if constexpr (SHARED_A) {
    return row_dot_shared<I>(a_s, d, Groups{});
  } else {
    return row_dot<I>(a_s, d, Cols{});
  }
}

template <int... J>
__device__ __forceinline__ void centre(const float (&t)[P], float (&d)[P],
                                       std::integer_sequence<int, J...>) {
  ((d[J] = t[J] - form<MU + J>()), ...);
}

// r_i += c * grad_i with grad = -A d
template <int... I>
__device__ __forceinline__ void kick(uint32_t a_s, const float (&d)[P], float (&r)[P], float c,
                                     std::integer_sequence<int, I...>) {
  ((r[I] = r[I] + c * (-row<I>(a_s, d))), ...);
}

// d^T A d, summed over rows in order, as the plain version's value_cols
template <int... I>
__device__ __forceinline__ float quad_form(uint32_t a_s, const float (&d)[P],
                                           std::integer_sequence<int, I...>) {
  float quad = 0.0f;
  ((quad = quad + d[I] * row<I>(a_s, d)), ...);
  return quad;
}

// the velocity im * r (r for unit mass), the drift and the kinetic sum
template <int J>
__device__ __forceinline__ float velocity(float r) {
  if constexpr (UNIT) {
    return r;
  } else {
    return form<IM + J>() * r;
  }
}

template <int... J>
__device__ __forceinline__ void drift(float (&t)[P], const float (&r)[P], float eps,
                                      std::integer_sequence<int, J...>) {
  ((t[J] = t[J] + eps * velocity<J>(r[J])), ...);
}

template <int... J>
__device__ __forceinline__ float kinetic_sum(const float (&r)[P],
                                             std::integer_sequence<int, J...>) {
  float kin = 0.0f;
  ((kin = kin + r[J] * velocity<J>(r[J])), ...);
  return kin;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(BLOCK)
    hmc_chunk_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* ms_s = reinterpret_cast<float*>(smem4);  // P4 momentum scales 1 / sqrt(im)
  float* tcur_s = ms_s + P4;                      // P * BLOCK, [j][thread]

  if constexpr (!UNIT) {
    for (int j = threadIdx.x; j < P; j += BLOCK) ms_s[j] = 1.0f / sqrtf(a.form[IM + j]);
  }
  uint32_t a_s = 0;  // shared address of A where SHARED_A
  if constexpr (SHARED_A) {
    float* A_s = tcur_s + P * BLOCK;  // P x P4, 16-byte aligned (BLOCK and P4 are multiples of 4)
    for (int i = threadIdx.x; i < P * P4; i += BLOCK) {
      const int row = i / P4, col = i % P4;
      A_s[i] = col < P ? a.form[row * P + col] : 0.0f;
    }
    a_s = static_cast<uint32_t>(__cvta_generic_to_shared(A_s));
  }
  __syncthreads();

  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= a.K) return;  // ragged edge; no barrier follows
  const size_t Ks = static_cast<size_t>(a.K);

  float tp[P], r[P], d[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    tp[j] = a.theta[j * Ks + k];
    tcur_s[j * BLOCK + threadIdx.x] = tp[j];
  }
  float lp = a.logp[k];
  float ev = a.ev[k], ea = a.ea[k], evr = a.evr[k];
  int en = a.en[k], ec = a.ec[k];
  const float it = a.inv_temp[k];
  const bool store = a.h_theta != nullptr;

  for (int c = 0; c < a.chunk; ++c) {
    const size_t cK = static_cast<size_t>(c) * Ks;
    const float* zc = a.z + cK * P + k;

    // momentum draw
#pragma unroll
    for (int j = 0; j < P; ++j) r[j] = UNIT ? zc[j * Ks] : ms_s[j] * zc[j * Ks];
    const float h0 = 0.5f * kinetic_sum(r, Cols{}) - lp;

    const int n = step_count(a.us[cK + k], a.steps, a.max_steps);

    const float eps = ev;
    const float r_step = it * eps;
    const float half = 0.5f * r_step;
    centre(tp, d, Cols{});
    kick(a_s, d, r, half, Cols{});
    for (int s = 0; s < n; ++s) {
      drift(tp, r, eps, Cols{});
      centre(tp, d, Cols{});
      kick(a_s, d, r, s == n - 1 ? half : r_step, Cols{});
    }

    const float p = (-0.5f * quad_form(a_s, d, Cols{})) * it;
    const float h = 0.5f * kinetic_sum(r, Cols{}) - p;
    const float ap = expf(h0 - h);

    adapt(ap, ev, ea, evr, en, ec);

    // duplicate-on-reject
    const bool accepted = (ap >= 1.0f) || (a.ua[cK + k] <= ap);
    if (accepted) {
      lp = p;
#pragma unroll
      for (int j = 0; j < P; ++j) tcur_s[j * BLOCK + threadIdx.x] = tp[j];
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) tp[j] = tcur_s[j * BLOCK + threadIdx.x];
    }

    if (store) {
#pragma unroll
      for (int j = 0; j < P; ++j) a.h_theta[(cK * P) + j * Ks + k] = tp[j];
      a.h_logp[cK + k] = lp;
      a.h_steps[cK + k] = n;
      a.h_eps[cK + k] = ev;
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) a.theta_o[j * Ks + k] = tp[j];
  a.logp_o[k] = lp;
  a.ev_o[k] = ev;
  a.ea_o[k] = ea;
  a.evr_o[k] = evr;
  a.en_o[k] = en;
  a.ec_o[k] = ec;
}

namespace {

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (P4 + static_cast<size_t>(P) * BLOCK +
                                       (SHARED_A ? P * P4 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      hmc_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.K + BLOCK - 1) / BLOCK;
  hmc_chunk_kernel<<<grid, BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches one chunk on `stream` and returns a CUDA error code (0 on
// success; cudaErrorInvalidValue when P or the kind of mass is not this
// library's). The form's operands inv_mass (P), A (P x P, row major) and mu
// (P) are host pointers, copied into the launch's parameters; inv_mass is
// null for unit mass. Every other pointer is a device pointer; the four
// history pointers are all null (no history) or all set.
extern "C" int hmc_fused_chunk(
    const float* theta, const float* logp, const float* ev, const float* ea,
    const float* evr, const int* en, const int* ec, const float* inv_temp,
    const float* z, const float* us, const float* ua, const float* inv_mass,
    const float* A, const float* mu, float* theta_o, float* logp_o, float* ev_o,
    float* ea_o, float* evr_o, int* en_o, int* ec_o, float* h_theta,
    float* h_logp, int* h_steps, float* h_eps, int n_params, int K, int chunk,
    int steps, int max_steps, void* stream) {
  if (n_params != P || (inv_mass == nullptr) != UNIT || A == nullptr || mu == nullptr ||
      K < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua,
            theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
            h_theta, h_logp, h_steps, h_eps, K, chunk, steps, max_steps};
  memcpy(args.form, A, sizeof(float) * P * P);
  memcpy(args.form + MU, mu, sizeof(float) * P);
  if (!UNIT) memcpy(args.form + IM, inv_mass, sizeof(float) * P);
  return static_cast<int>(launch(args, static_cast<cudaStream_t>(stream)));
}

#else  // B1_P == 0: the wide route

struct WideArgs {
  // state in, random operands, state out and history: as the narrow Args
  const float* theta;     // (P, K)
  const float* logp;      // (K,)
  const float* ev;        // (K,) eps.value
  const float* ea;        // (K,) eps.avg
  const float* evr;       // (K,) eps.var
  const int* en;          // (K,) eps.num
  const int* ec;          // (K,) eps.chk_int
  const float* inv_temp;  // (K,)
  const float* z;         // (chunk, P, K) standard normals
  const float* us;        // (chunk, K) step-count uniforms
  const float* ua;        // (chunk, K) accept uniforms
  // the form on the device, zero padded to P4: the diagonal inverse mass
  // (P4, null for unit mass), A (P4 x P4, row major) and mu (P4)
  const float4* inv_mass;
  const float4* A;
  const float4* mu;
  float* theta_o;
  float* logp_o;
  float* ev_o;
  float* ea_o;
  float* evr_o;
  int* en_o;
  int* ec_o;
  float* h_theta;         // (chunk, P, K), all four null without store
  float* h_logp;          // (chunk, K)
  int* h_steps;           // (chunk, K)
  float* h_eps;           // (chunk, K)
  int P, P4, K, chunk, steps, max_steps;
};

namespace {

constexpr int WARPS_MAX = 4;  // chains (warps) per block, fewer where shared memory is short
constexpr int SMEM_MAX = 200 * 1024;  // of the 227 KB a block may have

// the sum of v over the warp, the same bits on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float4 velocity4(const float4 r, const float4* im4, int q) {
  if (im4 == nullptr) return r;
  const float4 m = im4[q];
  return make_float4(m.x * r.x, m.y * r.y, m.z * r.z, m.w * r.w);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// (A d) for the rows 4q .. 4q+3, accumulated over j in order with fmaf from 0
__device__ __forceinline__ float4 matvec4(const float4* __restrict__ A, const float* d, int Q,
                                          int q) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* col = A + q;
#pragma unroll 4
  for (int j = 0; j < 4 * Q; ++j) {
    const float4 a = __ldg(col + static_cast<size_t>(j) * Q);
    const float dj = d[j];
    acc.x = fmaf(a.x, dj, acc.x);
    acc.y = fmaf(a.y, dj, acc.y);
    acc.z = fmaf(a.z, dj, acc.z);
    acc.w = fmaf(a.w, dj, acc.w);
  }
  return acc;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(32 * WARPS_MAX)
    hmc_wide_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= a.K) return;  // a whole warp; no block barrier follows
  const int P = a.P, Q = a.P4 / 4;
  const size_t Ks = static_cast<size_t>(a.K);
  // the warp's state: position, momentum, centred position, current position
  float4* t4 = smem4 + static_cast<size_t>(warp) * 4 * Q;
  float4* r4 = t4 + Q;
  float4* d4 = r4 + Q;
  float4* c4 = d4 + Q;
  float* t = reinterpret_cast<float*>(t4);
  float* r = reinterpret_cast<float*>(r4);
  const float* d = reinterpret_cast<const float*>(d4);
  float* tc = reinterpret_cast<float*>(c4);

  for (int i = lane; i < 4 * Q; i += 32) {
    const float v = i < P ? a.theta[i * Ks + k] : 0.0f;
    t[i] = v;
    tc[i] = v;
  }
  float lp = a.logp[k];
  float ev = a.ev[k], ea = a.ea[k], evr = a.evr[k];
  int en = a.en[k], ec = a.ec[k];
  const float it = a.inv_temp[k];
  const bool store = a.h_theta != nullptr;
  __syncwarp();

  for (int c = 0; c < a.chunk; ++c) {
    const size_t cK = static_cast<size_t>(c) * Ks;
    const float* zc = a.z + cK * P + k;
    __syncwarp();  // the last transition's reads of r and t are done

    // momentum draw (1 / sqrt(im) scales it) and its kinetic energy
    float kin = 0.0f;
    for (int i = lane; i < 4 * Q; i += 32) {
      float ri = 0.0f;
      if (i < P) {
        ri = zc[i * Ks];
        if (a.inv_mass != nullptr) {
          const float im = reinterpret_cast<const float*>(a.inv_mass)[i];
          ri = (1.0f / sqrtf(im)) * ri;
          kin = kin + ri * (im * ri);
        } else {
          kin = kin + ri * ri;
        }
      }
      r[i] = ri;
    }
    const float h0 = 0.5f * warp_sum(kin) - lp;
    const int n = step_count(a.us[cK + k], a.steps, a.max_steps);
    const float eps = ev;
    const float r_step = it * eps;
    const float half = 0.5f * r_step;

    // centre, the first half kick, then n drifts and kicks; the last kick
    // is halved and also gives the quadratic form d^T A d
    __syncwarp();
    for (int q = lane; q < Q; q += 32) {
      const float4 tq = t4[q], m = a.mu[q];
      d4[q] = make_float4(tq.x - m.x, tq.y - m.y, tq.z - m.z, tq.w - m.w);
    }
    __syncwarp();
    for (int q = lane; q < Q; q += 32) {
      const float4 g = matvec4(a.A, d, Q, q);
      float4 rq = r4[q];
      rq.x = rq.x + half * (-g.x);
      rq.y = rq.y + half * (-g.y);
      rq.z = rq.z + half * (-g.z);
      rq.w = rq.w + half * (-g.w);
      r4[q] = rq;
    }
    float quad = 0.0f;
    for (int s = 0; s < n; ++s) {
      const bool last = s == n - 1;
      const float kick = last ? half : r_step;
      __syncwarp();  // every lane has read d
      for (int q = lane; q < Q; q += 32) {
        const float4 v = velocity4(r4[q], a.inv_mass, q);
        float4 tq = t4[q];
        tq.x = tq.x + eps * v.x;
        tq.y = tq.y + eps * v.y;
        tq.z = tq.z + eps * v.z;
        tq.w = tq.w + eps * v.w;
        t4[q] = tq;
        const float4 m = a.mu[q];
        d4[q] = make_float4(tq.x - m.x, tq.y - m.y, tq.z - m.z, tq.w - m.w);
      }
      __syncwarp();  // d is whole
      for (int q = lane; q < Q; q += 32) {
        const float4 g = matvec4(a.A, d, Q, q);
        float4 rq = r4[q];
        rq.x = rq.x + kick * (-g.x);
        rq.y = rq.y + kick * (-g.y);
        rq.z = rq.z + kick * (-g.z);
        rq.w = rq.w + kick * (-g.w);
        r4[q] = rq;
        if (last) quad = quad + dot4(d4[q], g);
      }
    }

    const float p = (-0.5f * warp_sum(quad)) * it;
    float kin_end = 0.0f;
    for (int q = lane; q < Q; q += 32) kin_end = kin_end + dot4(r4[q], velocity4(r4[q], a.inv_mass, q));
    const float h = 0.5f * warp_sum(kin_end) - p;
    const float ap = expf(h0 - h);
    adapt(ap, ev, ea, evr, en, ec);

    // duplicate-on-reject, each lane on its own rows
    const bool accepted = (ap >= 1.0f) || (a.ua[cK + k] <= ap);
    if (accepted) lp = p;
    for (int q = lane; q < Q; q += 32) {
      if (accepted) {
        c4[q] = t4[q];
      } else {
        t4[q] = c4[q];
      }
    }
    if (store) {
      __syncwarp();  // each lane stores rows that other lanes accepted or restored
      for (int i = lane; i < P; i += 32) a.h_theta[(cK * P) + i * Ks + k] = tc[i];
      if (lane == 0) {
        a.h_logp[cK + k] = lp;
        a.h_steps[cK + k] = n;
        a.h_eps[cK + k] = ev;
      }
    }
  }

  __syncwarp();
  for (int i = lane; i < P; i += 32) a.theta_o[i * Ks + k] = tc[i];
  if (lane == 0) {
    a.logp_o[k] = lp;
    a.ev_o[k] = ev;
    a.ea_o[k] = ea;
    a.evr_o[k] = evr;
    a.en_o[k] = en;
    a.ec_o[k] = ec;
  }
}

// Launches one chunk of the wide route on `stream` and returns a CUDA error
// code (0 on success; cudaErrorInvalidValue for P < 1, a P4 that is not P
// rounded up to a multiple of 4, a P too large for one warp's state in
// shared memory, or a missing form pointer). The form's operands inv_mass
// (P4, null for unit mass), A (P4 x P4, row major, symmetric, zero padded)
// and mu (P4, zero padded) are device pointers, 16-byte aligned; so is
// every other pointer. The four history pointers are all null (no history)
// or all set.
extern "C" int hmc_fused_chunk_wide(
    const float* theta, const float* logp, const float* ev, const float* ea,
    const float* evr, const int* en, const int* ec, const float* inv_temp,
    const float* z, const float* us, const float* ua, const float* inv_mass,
    const float* A, const float* mu, float* theta_o, float* logp_o, float* ev_o,
    float* ea_o, float* evr_o, int* en_o, int* ec_o, float* h_theta,
    float* h_logp, int* h_steps, float* h_eps, int n_params, int P4, int K, int chunk,
    int steps, int max_steps, void* stream) {
  const size_t per_warp = sizeof(float) * 4 * static_cast<size_t>(P4);
  if (n_params < 1 || P4 != (n_params + 3) / 4 * 4 || per_warp > SMEM_MAX || A == nullptr ||
      mu == nullptr || K < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs args{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua,
                reinterpret_cast<const float4*>(inv_mass), reinterpret_cast<const float4*>(A),
                reinterpret_cast<const float4*>(mu),
                theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
                h_theta, h_logp, h_steps, h_eps, n_params, P4, K, chunk, steps, max_steps};
  const int warps = static_cast<int>(std::min<size_t>(WARPS_MAX, SMEM_MAX / per_warp));
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      hmc_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (K + warps - 1) / warps;
  hmc_wide_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

#endif
