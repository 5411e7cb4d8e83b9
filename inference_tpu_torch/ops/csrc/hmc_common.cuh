// What kernel B1 (hmc_fused.cu) and the model route (hmc_model.cu) share:
// the step-size adaptation of one transition and the jittered step count,
// as inference_tpu_torch/ops/hmc_fused.py's plain version
// (_transition_math) computes them; the cp.async copies of a ring of rows
// into shared memory; and a fixed-order sum of a block's partial sums.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// rows [r0, r0 + n) of a row-major matrix of `rows` floats a row (a
// multiple of 4) into dst by cp.async, by the whole block, 16 bytes a copy
__device__ __forceinline__ void copy_rows(float* dst, const float4* A, int r0, int n, int rows) {
  const float4* src = A + size_t(r0) * (rows / 4);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < n * (rows / 4); q += blockDim.x) cp_async16(d + q, src + q);
}

// the sum of x[q * stride] over q < n in a fixed order: four interleaved
// running sums (q mod 4), then ((s0 + s1) + (s2 + s3))
__device__ __forceinline__ float row_sum(const float* x, int n, int stride) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int q = 0;
  for (; q + 4 <= n; q += 4) {
    s0 = s0 + x[q * stride];
    s1 = s1 + x[(q + 1) * stride];
    s2 = s2 + x[(q + 2) * stride];
    s3 = s3 + x[(q + 3) * stride];
  }
  if (q < n) s0 = s0 + x[q * stride];
  if (q + 1 < n) s1 = s1 + x[(q + 1) * stride];
  if (q + 2 < n) s2 = s2 + x[(q + 2) * stride];
  return (s0 + s1) + (s2 + s3);
}

}  // namespace
