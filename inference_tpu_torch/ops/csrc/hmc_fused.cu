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
// longer fits a block's shared memory from P = 239. The route has two
// kernels, and ops/hmc_fused.py::wide_plan picks one and its sizes by P and
// the chain count K.
//
// hmc_tile_kernel, for P up to 2,048. What bounds it: each leapfrog step is
// a product G = A D of A with the (P x chains) centred positions, 2 P^2
// flops per chain, so a block of C chains that shares each value of A it
// reads does C/2 flops per byte of A. With one chain per reader (the
// warp-per-chain kernel below) the product is bound by the L1/L2 feed of A
// and by two loads per four FFMA. The design:
//   - A block owns C neighbouring chains (up to 64). Positions, momenta and
//     the history are stored (P, K), so its chains make coalesced rows.
//   - Each thread owns an 8-row by 4-chain tile of G and keeps the momentum
//     of those entries in registers, in the layout of its tile, so drifts
//     and kicks move no data. Per j it reads 8 values of row j of A (A is
//     symmetric: (A d)_i = sum_j A[j][i] d_j) and 4 of row j of D, three
//     LDS.128 broadcast across the warp (a warp spans two or more tile
//     rows), against 32 FFMA, accumulated over j in order from 0 with fmaf
//     as above. The positions and D live in shared memory.
//   - The block's shared memory is sized so that two blocks share an SM
//     (wide_plan): one block's barriers and waits are the other's issue
//     slots. A stays resident there where it fits beside the block's tiles
//     (P up to 104 at C = 64); the block copies it once with cp.async, and
//     a step then reads no device memory. Above that A streams through a
//     ring of 2 or 3 stages of 16 rows (fewer where shared memory is short;
//     cp.async), the next slab in flight while the FFMAs run, and C is as
//     large as the threads allow (32 at P = 256), so the L2 feeds A at C/2
//     flops a byte.
//   - Step counts differ per chain (+-10% of steps). The block's chains take
//     each transition in lockstep: the block runs to the largest n among
//     them, and a chain past its own n is frozen (no drift, no kick; its D,
//     so its products, unchanged), as in the TPU kernel's mask. That costs
//     about 9% more steps at C = 64 (chip_smoke.py prints the count and
//     times it against a chunk whose blocks share their step draws).
//     Letting each chain move on to its next transition at its own pace
//     would save most of those steps, but then transition ends fall on
//     most steps, each with its barriers and waits; that design is not
//     built here, and its time is not measured.
//   - At a transition's end the threads that share a chain write their
//     partial sums of the quadratic form (d^T G of the chain's last kick's
//     own product: its D is unchanged since) and of the kinetic energy to
//     shared memory, beside those of the momentum draw, and the chain's
//     owner thread sums them in a fixed order, accepts and adapts: every
//     thread sees the same bits, so accept and reject stay uniform. The
//     current position of each chain waits in theta_o (which holds the
//     positions when the chunk ends). The loads the end needs are issued
//     ahead: the next normals and the current position before the owner's
//     barrier, the owner's uniforms a transition ahead.
//   - A transition takes n + 1 products (its first half kick needs the
//     gradient where it starts), as in the plain version.
// The sums round in another order than the plain version's, so the wide
// route agrees with it within the float32 tolerance, not bit for bit.
//
// hmc_wide_kernel, for larger P (up to 12,800): one warp owns one chain,
// its position, momentum, centred position and current position (4 x rows
// floats) in the warp's share of shared memory; lane l owns the groups of
// four rows q = l, l + 32, ... of every elementwise step and of the
// product, and reads row j of A as 32 neighbouring float4s from the padded
// copy in device memory (through L1 and L2) while d_j is a shared-memory
// broadcast. Its sums are butterflies across the warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>
#include <utility>

#include "hmc_common.cuh"  // adapt, step_count

#if !defined(B1_P) || (B1_P > 0 && !defined(B1_UNIT))
#error "kernel B1 is built per parameter count and mass: nvcc -DB1_P=<1..64> -DB1_UNIT=<0|1>, or -DB1_P=0 for the wide route"
#endif

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
  // the form on the device, zero padded: the diagonal inverse mass (rows,
  // null for unit mass), A (P rounded up to 16 rows of `rows` floats, row
  // major) and mu (rows)
  const float4* inv_mass;
  const float4* A;
  const float4* mu;
  float* theta_o;         // (P, K); the tiled kernel keeps each chain's current position here
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
  int P, K, chunk, steps, max_steps;
  // the plan (ops/hmc_fused.py::wide_plan): rows = P rounded up to 8, the
  // rows of A a matvec walks (depth), chains per block, and rows of A per
  // ring stage (slab; 0 with A resident)
  int rows, depth, chains, slab;
};

namespace {

// the tiled kernel: a thread's tile of the gradient G is TM rows by TN chains
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int TILE_THREADS = 256;      // most threads of a block (two blocks an SM)
constexpr int TILE_CHAINS_MAX = 64;    // most chains of a block: a warp spans two or more tile rows
constexpr size_t SMEM_BLOCK = 232448;  // the 227 KB a block may have
// the warp-per-chain kernel, for the P the tiled kernel's shared memory cannot take
constexpr int WARPS_MAX = 4;
constexpr size_t SMEM_WARPS = 200 * 1024;
constexpr int CHAIN_WORDS = 11;        // per-chain words in shared memory (see the kernel)

// Shared memory of a tiled block, in bytes (ops/hmc_fused.py::_tile_smem
// computes the same): A (resident, depth x rows, or `stages` slabs of
// slab x rows), the centred tile D and the positions (depth x chains each),
// the partial sums (3 x rows/TM x chains), mu, the inverse mass and the
// momentum scales (rows each) and CHAIN_WORDS words per chain.
size_t tile_smem(int rows, int depth, int chains, int slab, int stages) {
  const size_t a = stages == 0 ? size_t(depth) * rows : size_t(stages) * slab * rows;
  const size_t words = a + 2 * size_t(depth) * chains + 3 * size_t(rows / TM) * chains +
                       3 * size_t(rows) + CHAIN_WORDS * size_t(chains);
  return 4 * words;
}

// the sum of v over the warp, the same bits on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// g[i][c] += A[j][row0 + i] * D[j][col0 + c] for one j: the thread's TM
// values of row j of A (A is symmetric) and TN values of row j of D, each
// an LDS.128, against TM * TN FFMA
__device__ __forceinline__ void fma_tile(float (&g)[TM][TN], const float* a, const float* d) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  const float4 dv = *reinterpret_cast<const float4*>(d);
  const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float dd[TN] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < TN; ++c) g[i][c] = fmaf(av[i], dd[c], g[i][c]);
  }
}

// The thread's TN neighbouring chains k .. k + TN - 1 (k a multiple of 4)
// of the row at `at` (chain k's index) of a (rows, K) array in device
// memory: one 16-byte access where K is a multiple of 4 (then all TN
// chains exist), else one per chain that exists (0 for one that does not).
__device__ __forceinline__ void load_row(float (&v)[TN], const float* x, size_t at, int k, int K) {
  if (K % 4 == 0) {
    const float4 q = *reinterpret_cast<const float4*>(x + at);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < TN; ++c) v[c] = k + c < K ? x[at + c] : 0.0f;
  }
}

__device__ __forceinline__ void store_row(float* x, size_t at, const float (&v)[TN], int k, int K) {
  if (K % 4 == 0) {
    *reinterpret_cast<float4*>(x + at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      if (k + c < K) x[at + c] = v[c];
    }
  }
}

}  // namespace

// The tiled kernel (see the header): a block of `chains` chains, A resident
// in shared memory (STAGES == 0) or streamed through a ring of STAGES slabs.
template <int STAGES>
__global__ void __launch_bounds__(TILE_THREADS, 2) hmc_tile_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, PR = a.rows, J = a.depth, C = a.chains, KS = a.slab;
  const int K = a.K, chunk = a.chunk;
  const int TR = PR / TM, TC = C / TN, tid = threadIdx.x;
  // thread -> tile: chain groups side by side (at most 16, C <= 64), then
  // rows, so a warp reads two or more rows of A and up to 64 chains of D,
  // broadcasts without bank conflicts
  const int tr = tid / TC;
  const int row0 = TM * tr;              // the tile's first row
  const int col0 = TN * (tid - tr * TC);  // and first chain in the block
  const int kb = blockIdx.x * C;         // the block's first chain
  const size_t Ks = static_cast<size_t>(K);
  const bool store = a.h_theta != nullptr;

  float* A_s = reinterpret_cast<float*>(smem4);
  float* D_s = A_s + (STAGES == 0 ? size_t(J) * PR : size_t(STAGES) * KS * PR);  // [j][chain]
  float* T_s = D_s + size_t(J) * C;      // positions, [row][chain]
  float* red = T_s + size_t(J) * C;      // partial sums, [3][tile row][chain]
  float* mu_s = red + 3 * size_t(TR) * C;
  float* im_s = mu_s + PR;
  float* ms_s = im_s + PR;
  // per chain (CHAIN_WORDS words): the step size, the kick coefficients, the
  // owner's state, the step count and the accept flag
  float* ev_s = ms_s + PR;
  float* rstep_s = ev_s + C;
  float* half_s = rstep_s + C;
  float* lp_s = half_s + C;
  float* ea_s = lp_s + C;
  float* evr_s = ea_s + C;
  float* it_s = evr_s + C;
  int* en_s = reinterpret_cast<int*>(it_s + C);
  int* ec_s = en_s + C;
  int* n_s = ec_s + C;
  int* acc_s = n_s + C;

  // A: all of it (resident), or the ring's first STAGES - 1 slabs
  const int NS = STAGES == 0 ? 1 : J / KS;
  if constexpr (STAGES == 0) {
    copy_rows(A_s, a.A, 0, J, PR);
    cp_async_commit();
  } else {
    for (int s = 0; s < STAGES - 1; ++s) {
      copy_rows(A_s + size_t(s) * KS * PR, a.A, (s % NS) * KS, KS, PR);
      cp_async_commit();
    }
  }
  // the form per row (unit mass: an inverse mass of 1, whose products are
  // exact), the positions, D zeroed past P and the current positions
  const float* mug = reinterpret_cast<const float*>(a.mu);
  const float* img = reinterpret_cast<const float*>(a.inv_mass);
  for (int i = tid; i < PR; i += blockDim.x) {
    const float im = (img != nullptr && i < P) ? img[i] : 1.0f;
    mu_s[i] = mug[i];
    im_s[i] = im;
    ms_s[i] = 1.0f / sqrtf(im);
  }
  for (int q = tid; q < J * C; q += blockDim.x) {
    const int i = q / C, k = kb + q % C;
    const bool in = i < P && k < K;
    const float v = in ? a.theta[i * Ks + k] : 0.0f;
    T_s[q] = v;
    D_s[q] = 0.0f;
    if (in) a.theta_o[i * Ks + k] = v;  // theta_o holds each chain's current position
  }

  // chain tid's scalars are kept by thread tid (its owner) in shared memory;
  // the owner holds, loaded a transition ahead, the uniforms it will need
  // (the accept draw of this transition, the step draw of the next)
  const int ko = kb + tid;
  const bool owner = tid < C && ko < K;
  float u_acc = 0.0f, u_next = 0.0f;
  if (tid < C) n_s[tid] = 0;  // a chain past K takes no step
  if (owner) {
    const float ev = a.ev[ko], it = a.inv_temp[ko];
    lp_s[tid] = a.logp[ko];
    ev_s[tid] = ev;
    ea_s[tid] = a.ea[ko];
    evr_s[tid] = a.evr[ko];
    en_s[tid] = a.en[ko];
    ec_s[tid] = a.ec[ko];
    it_s[tid] = it;
    rstep_s[tid] = it * ev;
    half_s[tid] = 0.5f * (it * ev);
    n_s[tid] = step_count(a.us[ko], a.steps, a.max_steps);
    u_acc = a.ua[ko];
    if (chunk > 1) u_next = a.us[Ks + ko];
  }
  // the momentum r holds each transition's raw normals until its step 0
  const int kg = kb + col0;  // the thread's first chain
  float r[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + i;
#pragma unroll
    for (int c = 0; c < TN; ++c) r[i][c] = 0.0f;
    if (row < P && kg < K) load_row(r[i], a.z, row * Ks + kg, kg, K);
  }
  if constexpr (STAGES == 0) cp_async_wait_all();
  __syncthreads();  // the form, the positions, the chains' state and (resident) A are in place

  int slab = 0;  // slabs of A consumed (streamed)
  for (int t = 0; t < chunk; ++t) {
    // The block's chains take the transition in lockstep: step 0 the
    // momentum draw and the first half kick, steps 1..n of each chain's own
    // n a drift and a kick (the last halved); a chain past its n is frozen
    // (its D, so its products, unchanged) until the block's largest n.
    int nc[TN];  // each tile chain's n, -1 past K
    int nmax = 0;
#pragma unroll
    for (int c = 0; c < TN; ++c) nc[c] = kb + col0 + c < K ? n_s[col0 + c] : -1;
    for (int q = 0; q < C; ++q) nmax = max(nmax, n_s[q]);
    float g[TM][TN];
    const float4 ev4 = *reinterpret_cast<const float4*>(ev_s + col0);
    for (int s = 0; s <= nmax; ++s) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = row0 + i;
        if (row < P) {
          float4* tp = reinterpret_cast<float4*>(T_s + row * C + col0);
          float4 t4 = *tp;
          const float im = im_s[row], m = mu_s[row];
          if (s > 0 && s <= nc[0]) t4.x = t4.x + ev4.x * (im * r[i][0]);
          if (s > 0 && s <= nc[1]) t4.y = t4.y + ev4.y * (im * r[i][1]);
          if (s > 0 && s <= nc[2]) t4.z = t4.z + ev4.z * (im * r[i][2]);
          if (s > 0 && s <= nc[3]) t4.w = t4.w + ev4.w * (im * r[i][3]);
          *tp = t4;
          *reinterpret_cast<float4*>(D_s + row * C + col0) =
              make_float4(t4.x - m, t4.y - m, t4.z - m, t4.w - m);
        }
      }
      __syncthreads();  // D is whole

      // G = A D on the thread's tile, over j in order from 0 with fmaf
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int c = 0; c < TN; ++c) g[i][c] = 0.0f;
      }
      if constexpr (STAGES == 0) {
        const float* ap = A_s + row0;
        const float* dp = D_s + col0;
#pragma unroll 4
        for (int j = 0; j < J; ++j) fma_tile(g, ap + j * PR, dp + j * C);
      } else {
        for (int sl = 0; sl < NS; ++sl, ++slab) {
          cp_async_wait<STAGES - 2>();
          __syncthreads();  // slab `slab` is in; every thread is done with the stage refilled next
          const int next = slab + STAGES - 1;
          copy_rows(A_s + size_t(next % STAGES) * KS * PR, a.A, (next % NS) * KS, KS, PR);
          cp_async_commit();
          const float* ap = A_s + size_t(slab % STAGES) * KS * PR + row0;
          const float* dp = D_s + size_t(sl) * KS * C + col0;
#pragma unroll 2  // the ring's loop ran faster unrolled twice than four times
          for (int j = 0; j < KS; ++j) fma_tile(g, ap + j * PR, dp + j * C);
        }
      }

      // step 0 turns the raw normals into the momentum (1 / sqrt(im) z)
      // and sums its kinetic energy; then the kicks r += c * grad, grad =
      // -G: half at steps 0 and n
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        if (s <= nc[c]) {
          if (s == 0) {
            float kin0 = 0.0f;
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const int row = row0 + i;
              if (row < P) {
                const float ri = ms_s[row] * r[i][c];
                r[i][c] = ri;
                kin0 = kin0 + ri * (im_s[row] * ri);
              }
            }
            red[(2 * TR + tr) * C + col0 + c] = kin0;
          }
          const float coef = (s == 0 || s == nc[c]) ? half_s[col0 + c] : rstep_s[col0 + c];
#pragma unroll
          for (int i = 0; i < TM; ++i) r[i][c] = r[i][c] + coef * (-g[i][c]);
        }
      }
      __syncthreads();  // every thread is done reading D
    }

    // The transition's end. Each chain's last product is its own last
    // kick's (a frozen chain's D is unchanged), so per chain the partial
    // sums over the thread's rows of the quadratic form d^T G and of the
    // kinetic energy; then the loads the next phases wait for least: the
    // current position (into g) and the next transition's normals (into r).
    const bool more = t + 1 < chunk;
    if (kg < K) {
      float quad[TN], kin[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) quad[c] = kin[c] = 0.0f;
      const float* zn = a.z + size_t(t + 1) * P * Ks;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = row0 + i;
        if (row < P) {
          const float im = im_s[row];
          const float4 d4 = *reinterpret_cast<const float4*>(D_s + row * C + col0);
          const float d[TN] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            quad[c] = quad[c] + d[c] * g[i][c];
            kin[c] = kin[c] + r[i][c] * (im * r[i][c]);
          }
          const size_t at = row * Ks + kg;
          load_row(g[i], a.theta_o, at, kg, K);
          if (more) load_row(r[i], zn, at, kg, K);
        }
      }
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        red[tr * C + col0 + c] = quad[c];
        red[(TR + tr) * C + col0 + c] = kin[c];
      }
    }
    __syncthreads();
    if (owner) {  // the owner sums the rows in a fixed order: the same bits for every thread
      const float quad = row_sum(red + tid, TR, C);
      const float kin = row_sum(red + TR * C + tid, TR, C);
      const float kin0 = row_sum(red + 2 * TR * C + tid, TR, C);
      float lp = lp_s[tid], ev = ev_s[tid], ea = ea_s[tid], evr = evr_s[tid];
      int en = en_s[tid], ec = ec_s[tid];
      const float it = it_s[tid];
      const float h0 = 0.5f * kin0 - lp;
      const float p = (-0.5f * quad) * it;
      const float h = 0.5f * kin - p;
      const float ap = expf(h0 - h);
      adapt(ap, ev, ea, evr, en, ec);
      const bool accepted = (ap >= 1.0f) || (u_acc <= ap);  // duplicate-on-reject
      if (accepted) lp = p;
      acc_s[tid] = accepted;
      const size_t at = t * Ks + ko;
      if (store) {
        a.h_logp[at] = lp;
        a.h_steps[at] = n_s[tid];
        a.h_eps[at] = ev;
      }
      lp_s[tid] = lp;
      ev_s[tid] = ev;
      ea_s[tid] = ea;
      evr_s[tid] = evr;
      en_s[tid] = en;
      ec_s[tid] = ec;
      if (more) {
        n_s[tid] = step_count(u_next, a.steps, a.max_steps);
        rstep_s[tid] = it * ev;
        half_s[tid] = 0.5f * (it * ev);
        u_acc = a.ua[at + Ks];
        if (t + 2 < chunk) u_next = a.us[at + 2 * Ks];
      }
    }
    __syncthreads();
    // the proposal becomes the current position, or the current position
    // is restored (and written back unchanged); then the history
    if (kg < K) {
      bool accepted[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) accepted[c] = acc_s[col0 + c] != 0;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = row0 + i;
        if (row < P) {
          float4* tp = reinterpret_cast<float4*>(T_s + row * C + col0);
          const float4 t4 = *tp;
          float tv[TN] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            if (!accepted[c]) tv[c] = g[i][c];
          }
          *tp = make_float4(tv[0], tv[1], tv[2], tv[3]);
          const size_t at = row * Ks + kg;
          store_row(a.theta_o, at, tv, kg, K);
          if (store) store_row(a.h_theta + size_t(t) * P * Ks, at, tv, kg, K);
        }
      }
    }
  }
  if constexpr (STAGES != 0) cp_async_wait_all();  // the ring's last prefetches
  if (owner) {  // theta_o already holds the positions
    a.logp_o[ko] = lp_s[tid];
    a.ev_o[ko] = ev_s[tid];
    a.ea_o[ko] = ea_s[tid];
    a.evr_o[ko] = evr_s[tid];
    a.en_o[ko] = en_s[tid];
    a.ec_o[ko] = ec_s[tid];
  }
}
namespace {

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

// The warp-per-chain kernel (see the header), for P above the tiled
// kernel's reach: one warp owns one chain, its state in shared memory,
// and reads A (rows x rows of the padded copy) through L1 and L2.
extern "C" __global__ void __launch_bounds__(32 * WARPS_MAX)
    hmc_wide_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ float4 wsmem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= a.K) return;  // a whole warp; no block barrier follows
  const int P = a.P, Q = a.rows / 4;
  const size_t Ks = static_cast<size_t>(a.K);
  // the warp's state: position, momentum, centred position, current position
  float4* t4 = wsmem4 + static_cast<size_t>(warp) * 4 * Q;
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

namespace {

template <typename Kernel>
cudaError_t launch_wide(Kernel kernel, int grid, int threads, size_t smem, const WideArgs& args,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Launches one chunk of the wide route on `stream` with the plan of
// ops/hmc_fused.py::wide_plan and returns a CUDA error code (0 on success;
// cudaErrorInvalidValue for a plan the kernels do not take or a missing form
// pointer). The plan: `chains` chains per block of the tiled kernel, or 0
// for the warp-per-chain kernel; rows, P rounded up to 8; depth, the rows
// of A a matvec walks (rows for the warp kernel); slab and stages, the ring
// that streams A (both 0: A resident in shared memory, and for the warp
// kernel). The form's operands inv_mass (rows, null for unit mass), A (P
// rounded up to 16 rows of `rows` floats, row major, symmetric, zero padded)
// and mu (rows, zero padded) are device pointers, 16-byte aligned; so is
// every other pointer. The four history pointers are all null (no history)
// or all set.
extern "C" int hmc_fused_chunk_wide(
    const float* theta, const float* logp, const float* ev, const float* ea,
    const float* evr, const int* en, const int* ec, const float* inv_temp,
    const float* z, const float* us, const float* ua, const float* inv_mass,
    const float* A, const float* mu, float* theta_o, float* logp_o, float* ev_o,
    float* ea_o, float* evr_o, int* en_o, int* ec_o, float* h_theta,
    float* h_logp, int* h_steps, float* h_eps, int n_params, int K, int chunk,
    int steps, int max_steps, int chains, int rows, int depth, int slab, int stages,
    void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const int P = n_params;
  if (P < 1 || K < 1 || chunk < 1 || A == nullptr || mu == nullptr || rows % TM != 0 ||
      rows < P || rows >= P + TM || depth < P || depth % 4 != 0 || depth > (P + 15) / 16 * 16)
    return static_cast<int>(bad);
  const WideArgs args{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua,
                      reinterpret_cast<const float4*>(inv_mass), reinterpret_cast<const float4*>(A),
                      reinterpret_cast<const float4*>(mu),
                      theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
                      h_theta, h_logp, h_steps, h_eps, P, K, chunk, steps, max_steps,
                      rows, depth, chains, slab};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 0) {  // the warp-per-chain kernel
    const size_t per_warp = sizeof(float) * 4 * static_cast<size_t>(rows);
    if (depth != rows || slab != 0 || stages != 0 || per_warp > SMEM_WARPS)
      return static_cast<int>(bad);
    const int warps = static_cast<int>(std::min<size_t>(WARPS_MAX, SMEM_WARPS / per_warp));
    return static_cast<int>(
        launch_wide(hmc_wide_kernel, (K + warps - 1) / warps, 32 * warps, per_warp * warps, args, s));
  }
  const int threads = rows / TM * (chains / TN);
  const bool ring = stages != 0;
  if (chains < TN || chains % TN != 0 || chains > TILE_CHAINS_MAX ||
      threads > TILE_THREADS || threads < chains ||
      (ring ? (slab != 4 && slab != 8 && slab != 16) || depth % slab != 0 ||
                  (stages != 2 && stages != 3)
            : slab != 0) ||
      tile_smem(rows, depth, chains, slab, stages) > SMEM_BLOCK)
    return static_cast<int>(bad);
  const size_t smem = tile_smem(rows, depth, chains, slab, stages);
  const int grid = (K + chains - 1) / chains;
  cudaError_t err;
  if (stages == 0) {
    err = launch_wide(hmc_tile_kernel<0>, grid, threads, smem, args, s);
  } else if (stages == 2) {
    err = launch_wide(hmc_tile_kernel<2>, grid, threads, smem, args, s);
  } else {
    err = launch_wide(hmc_tile_kernel<3>, grid, threads, smem, args, s);
  }
  return static_cast<int>(err);
}

#endif
