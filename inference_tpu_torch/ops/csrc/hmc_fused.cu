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
// chunk. Against that it does about 55 * (2 P^2 + O(P)) FLOPs of matvec and
// integrator work (about 14 kFLOP at P = 10, some 300 FLOP per byte), far above
// the card's FP32-to-HBM ratio of about 20. So the kernel is bound by its
// instruction issue rate (FP32 and the shared-memory reads of A), and the
// bytes that matter are the normals, which a separate torch kernel writes to
// device memory before each launch and this kernel reads once.
//
// What the design does about it. One thread per chain keeps its proposal,
// momentum and centred position (three vectors of P_MAX floats) in registers
// through every leapfrog step of every transition in the chunk; the current
// position, needed only to restore it on a rejection, waits in shared memory.
// A is loaded once per block into shared memory, zero padded to P_MAX columns,
// and read as float4 broadcasts (every lane of a warp reads the same
// address), so one shared load feeds four fused multiply-adds. Each thread
// runs its own loop to its own step count. Loops over P are unrolled to
// P_MAX with uniform guards, so register arrays keep constant indices.
//
// Rounding. Built with --fmad=false, so no multiply and add are contracted
// behind the code's back: the step count, the energies and the adaptation
// round as the plain version's separate torch operations do. Only the matvec
// accumulation uses explicit fmaf, as the plain version's matmul does.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// step-size adaptation constants (mcmc/_kernels/hmc.py EPS_*)
constexpr float EPS_TARGET = 0.65f;
constexpr float EPS_GROWTH = 1.4f;
constexpr float EPS_VAR_FLOOR = 0.03f;
constexpr float EPS_POWER = 0.15f;
constexpr float EPS_MIN_ADJ = 0.5f;
constexpr float EPS_MAX_ADJ = 2.0f;

constexpr int BLOCK = 128;

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
  // mass and posterior operands
  const float* inv_mass;  // (P,) diagonal inverse mass
  const float* A;         // (P, P) symmetric
  const float* mu;        // (P,)
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
  int P, K, chunk, steps, max_steps;
};

template <int P_MAX>
__device__ __forceinline__ void centre(const float (&t)[P_MAX], const float* mu_s,
                                       float (&d)[P_MAX], int P) {
#pragma unroll
  for (int j = 0; j < P_MAX; ++j) {
    if (j < P) d[j] = t[j] - mu_s[j];
  }
}

// r_i += c * grad_i with grad = -A d; returns d^T A d, the quadratic form at
// the position d was centred from.
template <int P_MAX>
__device__ __forceinline__ float kick(const float* A_s, const float (&d)[P_MAX],
                                      float (&r)[P_MAX], float c, int P) {
  float quad = 0.0f;
#pragma unroll
  for (int i = 0; i < P_MAX; ++i) {
    if (i < P) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < P_MAX; j += 4) {
        if (j < P) {
          const float4 a4 = *reinterpret_cast<const float4*>(A_s + i * P_MAX + j);
          acc = fmaf(a4.x, d[j], acc);
          acc = fmaf(a4.y, d[j + 1], acc);
          acc = fmaf(a4.z, d[j + 2], acc);
          acc = fmaf(a4.w, d[j + 3], acc);
        }
      }
      r[i] = r[i] + c * (-acc);
      quad = quad + d[i] * acc;
    }
  }
  return quad;
}

template <int P_MAX>
__global__ void __launch_bounds__(BLOCK) hmc_chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // P_MAX * P_MAX, zero padded
  float* mu_s = A_s + P_MAX * P_MAX;              // P_MAX
  float* im_s = mu_s + P_MAX;                     // P_MAX inverse mass
  float* ms_s = im_s + P_MAX;                     // P_MAX momentum scale
  float* tcur_s = ms_s + P_MAX;                   // P * BLOCK, [j][thread]

  const int P = a.P;
  const int K = a.K;
  for (int i = threadIdx.x; i < P_MAX * P_MAX; i += BLOCK) {
    const int row = i / P_MAX, col = i % P_MAX;
    A_s[i] = (row < P && col < P) ? a.A[row * P + col] : 0.0f;
  }
  for (int i = threadIdx.x; i < P_MAX; i += BLOCK) {
    const bool in = i < P;
    const float im = in ? a.inv_mass[i] : 1.0f;
    mu_s[i] = in ? a.mu[i] : 0.0f;
    im_s[i] = im;
    ms_s[i] = 1.0f / sqrtf(im);
  }
  __syncthreads();

  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= K) return;  // ragged edge; no barrier follows
  const size_t Ks = static_cast<size_t>(K);

  float tp[P_MAX], r[P_MAX], d[P_MAX];
#pragma unroll
  for (int j = 0; j < P_MAX; ++j) {
    tp[j] = 0.0f;
    r[j] = 0.0f;
    d[j] = 0.0f;
    if (j < P) {
      tp[j] = a.theta[j * Ks + k];
      tcur_s[j * BLOCK + threadIdx.x] = tp[j];
    }
  }
  float lp = a.logp[k];
  float ev = a.ev[k], ea = a.ea[k], evr = a.evr[k];
  int en = a.en[k], ec = a.ec[k];
  const float it = a.inv_temp[k];
  const bool store = a.h_theta != nullptr;

  for (int c = 0; c < a.chunk; ++c) {
    const size_t cK = static_cast<size_t>(c) * Ks;
    const float* zc = a.z + cK * P + k;

    // momentum draw and initial energy
    float kin0 = 0.0f;
#pragma unroll
    for (int j = 0; j < P_MAX; ++j) {
      if (j < P) {
        const float r0 = ms_s[j] * zc[j * Ks];
        r[j] = r0;
        kin0 = kin0 + r0 * (im_s[j] * r0);
      }
    }
    const float h0 = 0.5f * kin0 - lp;

    // jittered step count, at least one drift
    const float u = a.us[cK + k];
    int n = static_cast<int>(static_cast<float>(a.steps) * (1.0f + (u - 0.5f) * 0.2f));
    n = max(min(n, a.max_steps), 1);

    const float eps = ev;
    const float r_step = it * eps;
    centre<P_MAX>(tp, mu_s, d, P);
    kick<P_MAX>(A_s, d, r, 0.5f * r_step, P);
    float quad = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float kick_c = (s == n - 1) ? 0.5f : 1.0f;
#pragma unroll
      for (int j = 0; j < P_MAX; ++j) {
        if (j < P) tp[j] = tp[j] + eps * (im_s[j] * r[j]);
      }
      centre<P_MAX>(tp, mu_s, d, P);
      quad = kick<P_MAX>(A_s, d, r, kick_c * r_step, P);
    }

    const float p = (-0.5f * quad) * it;
    float kin = 0.0f;
#pragma unroll
    for (int j = 0; j < P_MAX; ++j) {
      if (j < P) kin = kin + r[j] * (im_s[j] * r[j]);
    }
    const float h = 0.5f * kin - p;
    const float ap = expf(h0 - h);

    // step-size adaptation (submit_accept_prob)
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

    // duplicate-on-reject
    const bool accepted = (ap >= 1.0f) || (a.ua[cK + k] <= ap);
    if (accepted) {
      lp = p;
#pragma unroll
      for (int j = 0; j < P_MAX; ++j) {
        if (j < P) tcur_s[j * BLOCK + threadIdx.x] = tp[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < P_MAX; ++j) {
        if (j < P) tp[j] = tcur_s[j * BLOCK + threadIdx.x];
      }
    }

    if (store) {
#pragma unroll
      for (int j = 0; j < P_MAX; ++j) {
        if (j < P) a.h_theta[(cK * P) + j * Ks + k] = tp[j];
      }
      a.h_logp[cK + k] = lp;
      a.h_steps[cK + k] = n;
      a.h_eps[cK + k] = ev;
    }
  }

#pragma unroll
  for (int j = 0; j < P_MAX; ++j) {
    if (j < P) a.theta_o[j * Ks + k] = tp[j];
  }
  a.logp_o[k] = lp;
  a.ev_o[k] = ev;
  a.ea_o[k] = ea;
  a.evr_o[k] = evr;
  a.en_o[k] = en;
  a.ec_o[k] = ec;
}

template <int P_MAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (P_MAX * P_MAX + 3 * P_MAX + static_cast<size_t>(a.P) * BLOCK);
  cudaError_t err = cudaFuncSetAttribute(
      hmc_chunk_kernel<P_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.K + BLOCK - 1) / BLOCK;
  hmc_chunk_kernel<P_MAX><<<grid, BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches one chunk on `stream` and returns cudaGetLastError() (0 on
// success). Every pointer is a device pointer; the four history pointers are
// all null (no history) or all set.
extern "C" int hmc_fused_chunk(
    const float* theta, const float* logp, const float* ev, const float* ea,
    const float* evr, const int* en, const int* ec, const float* inv_temp,
    const float* z, const float* us, const float* ua, const float* inv_mass,
    const float* A, const float* mu, float* theta_o, float* logp_o, float* ev_o,
    float* ea_o, float* evr_o, int* en_o, int* ec_o, float* h_theta,
    float* h_logp, int* h_steps, float* h_eps, int P, int K, int chunk,
    int steps, int max_steps, void* stream) {
  if (P < 1 || P > 64 || K < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua, inv_mass, A, mu,
               theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
               h_theta, h_logp, h_steps, h_eps, P, K, chunk, steps, max_steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = P <= 16 ? launch<16>(a, s) : launch<64>(a, s);
  return static_cast<int>(err);
}
