// Kernel B1, model route: fused whole-trajectory HMC transitions of a
// posterior of the library's models with a linear forward model, written
// for Hopper (sm_90a).
//
// Replaces inference_tpu/ops/hmc_fused.py::_make_chunk_kernel on the
// posteriors that inference_tpu/ops/hmc_fused.py::_run_chunk runs through
// the user's closure (_converted_posterior, _eval_jaxpr_debatched): a
// Gaussian, Cauchy or Logistic likelihood over F = M theta + offset, with
// Gaussian, Exponential and Uniform priors. Its plain PyTorch version is
// inference_tpu_torch/ops/hmc_fused.py::_reference_chunk driven by
// inference_tpu_torch/ops/hmc_model.py::ModelForm's value_cols/grad_cols,
// and the wrapper that launches it is _launch_model_chunk in that module.
//
// What it computes. For every chain k, `chunk` duplicate-on-reject HMC
// transitions, each as kernel B1's (hmc_fused.cu): a momentum draw, a half
// kick, n drifts and kicks (the last halved, n jittered by +-10%), the
// tempered value and force, exp(h0 - h), the step-size adaptation, the
// accept draw; the same history layout. The value and its gradient are
// those of the posterior's __call__ under autodiff, per datum u = (y' -
// M theta) w with y' = y - offset and w the inverse scale:
//   Gaussian  -u^2 / 2,               dL/dF = u w
//   Cauchy    -log1p(u^2),            dL/dF = 2 u w / (1 + u^2)
//   Logistic  u - 2 softplus(u),      dL/dF = (2 sigmoid(u) - 1) w
// so the gradient is M^T dL/dF; a Gaussian prior adds (mean - t) / sigma^2,
// an Exponential one -lambda on all its variables unless any of them is
// below 0 (then its value is -1e100, -inf in float32, and its gradient 0,
// as autodiff of its where gives), a Uniform one 0 (its value -inf outside
// its box). The normalisation constants of every part join the value. A
// kick is r + coef (g_likelihood + g_prior), the plain version's order.
//
// What bounds it on this card. Each leapfrog step needs the gradient at a
// new position: two products with M, r = M theta (N x P by P x chains)
// and M^T psi, 4 N P flops a chain, plus N elementwise terms (a division
// for the Cauchy and the Logistic). Per byte of normals streamed (4 P a
// transition and chain) that is N x steps flops, so at any useful N the
// kernel is bound by FP32 FFMA issue (67 TFLOP/s), not by device memory.
// Between a simple kernel and that bound stand shared-memory traffic (a
// warp's 16-byte shared load takes 4 cycles of the SM's shared pipe, as
// the FMA pipe takes 4 warp FFMA a cycle, so a load must feed at least 8
// FFMA), block barriers (each costs the slowest warp's lag) and, with a
// block a SM, the latency the few warps leave unhidden. The plan
// (ops/hmc_model.py::model_plan) picks one of two routes by shape alone;
// each is its own library.
//
// The narrow route (P up to ops/hmc_model.py's NARROW_P_MAX, 52, and M
// with y' and w resident in shared memory), built once per P (HM_P),
// family and mass, so every loop over P unrolls with no padding: at small
// P a gradient is a few FFMA a datum, so per-datum overheads and
// barriers, not products, bound it.
//   - T lanes of one warp own a chain (T a power of two, 1 to 32, from the
//     plan: 16 at 4,096 chains). Each holds the chain's position, momentum
//     and gradient in registers and takes every T-th datum; the gradient
//     and, at the last step, the value's terms are summed over the T lanes
//     by __shfl_xor_sync butterflies (every lane ends with the same sums).
//   - M, y' and w are loaded once a launch into shared memory, rows of P +
//     2 words padded to 4 mod 8 words, so the 8 lanes of a quarter warp
//     reading 8 consecutive rows hit distinct banks. A datum is one row: P
//     FFMA for the residual and P for the gradient from the same loads.
//   - No block barrier after the load: chains that share a warp step
//     together to their largest step count (those done frozen), every
//     other chain at its own pace.
//   - Roundoff: the float32 chains' drift from float64 amplifies the
//     gradient's error, so a lane's sums run over 16 rows at a time and
//     the residual over two halves of P (one run over a lane's 64 rows
//     drifted measurably faster than the plain version).
//
// The wide route (any other P up to ops/hmc_model.py::model_p_max, 3,024),
// one library per family, mass and tiles a thread (HM_P = 0, HM_TILES): at
// P = 256 each datum is 2 x 256 FFMA a chain, so the products must run
// near the FMA pipe's rate.
//   - A block of 256 threads owns C chains (a power of two, 4 to 64). Each
//     thread owns an 8-row by 4-chain tile of the block's momenta in
//     registers for the whole chunk, and accumulates the same tile of the
//     gradient in registers through a pass over M; the owner applies the
//     kick and the drift and writes its tile's positions to shared memory.
//     Where the tiles are fewer than the threads, the pass's data rows are
//     split in GC groups whose partial gradients meet once a pass, not
//     once a slab. The kick is the plain version's r + coef (g + prior).
//     Past P = 2,048 (4 chains' momenta more than a tile a thread) a
//     thread owns two tiles of the same chains (HM_TILES = 2: 128
//     registers of momenta and gradients, so its loops are not unrolled).
//     The per-variable words (inverse mass, prior) are read by their
//     owners through L1, so shared memory holds the ring, the positions
//     and psi.
//   - One gradient is one pass over M in slabs of S rows streamed by
//     cp.async through a ring of 3 stages. The pass is software pipelined:
//     one phase takes the gradient product of slab i (M_slab^T psi, 8 x 4
//     tiles: 3 float4 loads a 32 FFMA) and the residual product of slab i +
//     1 (M_slab theta, 4 x 4 tiles: 8 float4 loads a 64 FFMA, in two sums
//     over alternate column quads; its contraction over P split in GA
//     groups where the tiles are fewer than the threads), then psi of slab
//     i + 1 (the family's derivative; two buffers), so a phase ends in one
//     block barrier, two with GA > 1. Ring rows are padded by 4 words so a
//     tile's 4 rows hit distinct banks; the padding holds y' and w.
//   - The block's chains step in lockstep to their largest step count;
//     those done are frozen (no drift, no kick). The pass at the last step
//     is at every chain's proposal and also sums the likelihood's terms.
// FP32 throughout with fmaf for the products, no TF32. The sums round in
// another order than the plain version's, so the kernel agrees with it
// within float32 roundoff, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hmc_common.cuh"  // adapt, step_count, the cp.async ring, row_sum

#if !defined(HM_FAMILY) || !defined(HM_UNIT) || !defined(HM_P) || !defined(HM_TILES)
#error "the model route is built per family, mass and route: nvcc -DHM_FAMILY=<0|1|2> -DHM_UNIT=<0|1> -DHM_P=<P|0> -DHM_TILES=<1|2>"
#endif

constexpr int FAMILY = HM_FAMILY;  // 0 Gaussian, 1 Cauchy, 2 Logistic
constexpr bool UNIT = HM_UNIT != 0;
static_assert(FAMILY >= 0 && FAMILY <= 2, "HM_FAMILY is 0, 1 or 2");
static_assert(HM_P >= 0, "HM_P is the narrow route's P, or 0 for the wide route");
static_assert(HM_TILES == 1 || HM_TILES == 2, "HM_TILES is the wide route's momentum tiles a thread");

struct ModelArgs {
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
  // the model, zero padded (ops/hmc_model.py::model_operands), row major:
  // on the wide route (N rounded up to 256, rows + 4) with y' and w in
  // columns rows and rows + 1, on the narrow route (N rounded up to 32, NW)
  // with y' and w in columns P and P + 1
  const float4* M;
  const float* vec;       // 4 x (P rounded up to 8) + 1: inverse mass, prior kind, prior a, prior b, normalisation
  // state out; the wide route's theta_o holds each chain's current position through the chunk
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
  int P, K, N, chunk, steps, max_steps;
  // the plan (ops/hmc_model.py::model_plan): chains a block; the narrow
  // route's lanes a chain, resident rows and words a row; the wide route's
  // rows (P rounded up to 8), the ring's words a row, data rows a slab and
  // the residual's and the gradient's contraction groups
  int chains, lanes, rows, stride, slab, ga, gc;
};

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_BLOCK = 232448;  // the 227 KB a block may have
// the prior's kinds, as ops/hmc_model.py writes them into vec
constexpr int GAUSSIAN = 1, EXPONENTIAL = 2, UNIFORM = 3;
// a chain's support flags: an Exponential variable below 0, a Uniform one
// outside its box
constexpr int EXP_OUT = 1, UNI_OUT = 2;

// the family's log term and dL/dF of one datum, u = (y' - M theta) w
__device__ __forceinline__ void family(float u, float w, float& value, float& dldf) {
  if constexpr (FAMILY == 0) {
    value = -0.5f * (u * u);
    dldf = u * w;
  } else if constexpr (FAMILY == 1) {
    const float uu = u * u;
    value = -log1pf(uu);
    dldf = (2.0f * w) * u / (1.0f + uu);
  } else {
    // softplus(u) = max(u, 0) + log1p(exp(-|u|)); 2 sigmoid(u) - 1 = 1 - 2 / (1 + exp(u))
    value = u - 2.0f * (fmaxf(u, 0.0f) + log1pf(expf(-fabsf(u))));
    dldf = (1.0f - 2.0f / (1.0f + expf(u))) * w;
  }
}

__device__ __forceinline__ float velocity(float im, float r) { return UNIT ? r : im * r; }

// a variable's support flags at th (kind, a, b as vec holds them)
__device__ __forceinline__ int support(int kind, float pa, float pb, float th) {
  if (kind == EXPONENTIAL && th < 0.0f) return EXP_OUT;
  if (kind == UNIFORM && !(pa <= th && th <= pb)) return UNI_OUT;
  return 0;
}

// the prior's term of the gradient added to g (autodiff's rule)
__device__ __forceinline__ float prior_grad(float g, int kind, float pa, float pb, float th,
                                            bool exp_out) {
  if (kind == GAUSSIAN) return g + ((pa - th) * pb) * pb;
  if (kind == EXPONENTIAL && !exp_out) return g + (-pa);
  return g;
}

// the prior's term of the value (the support flags give -inf apart)
__device__ __forceinline__ float prior_value(int kind, float pa, float pb, float th) {
  if (kind == GAUSSIAN) {
    const float zp = (pa - th) * pb;
    return -0.5f * (zp * zp);
  }
  if (kind == EXPONENTIAL) return -(pa * th);
  return 0.0f;
}

}  // namespace

#if HM_P > 0
// ---------------------------------------------------------------------------
// the narrow route: T lanes a chain, M resident
// ---------------------------------------------------------------------------

namespace {

constexpr int NARROW_ROWS = 32;        // resident rows, a multiple of this

// words of a resident row: M's P, y', w, zeros to 4 mod 8
constexpr int narrow_width(int p) {
  return (p + 5) / 4 * 4 % 8 == 0 ? (p + 5) / 4 * 4 + 4 : (p + 5) / 4 * 4;
}

// Shared memory of a block in bytes (ops/hmc_model.py::_narrow_smem
// computes the same): the resident rows and the four per-variable words.
size_t narrow_smem(int rows, int p) {
  return 4 * (size_t(rows) * narrow_width(p) + 4 * size_t((p + 7) / 8 * 8));
}

constexpr int NP = HM_P;
constexpr int NW = narrow_width(NP);   // words a resident row
constexpr int NV = NW / 4;
constexpr int VR = (NP + 7) / 8 * 8;   // vec's rows
constexpr int RUN = 16;                // rows a lane sums before adding to its sums
// blocks an SM the registers are held to: two up to P = 16, one above (a
// chain's 4 P registers no longer fit 128 a thread)
constexpr int NARROW_BLOCKS_SM = NP <= 16 ? 2 : 1;

// x summed over the T lanes of a chain: a butterfly, so every lane ends
// with the same sum in the same order
__device__ __forceinline__ float lanes_sum(float x, int T) {
  for (int o = T >> 1; o > 0; o >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One datum d: its residual (two sums over the halves of P), the family's
// derivative and its terms of the gradient into g; at LAST also its term
// of the value where d < N.
template <bool LAST>
__device__ __forceinline__ void narrow_row(const float4* __restrict__ Ms, int d, int N,
                                           const float (&th)[NP], float (&g)[NP], float& val) {
  const float4* row = Ms + size_t(d) * NV;
  float m[NW];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 x = row[v];
    m[4 * v] = x.x;
    m[4 * v + 1] = x.y;
    m[4 * v + 2] = x.z;
    m[4 * v + 3] = x.w;
  }
  float e0 = 0.0f, e1 = 0.0f;  // the residual in two halves, added at the end
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (p < (NP + 1) / 2) {
      e0 = fmaf(m[p], th[p], e0);
    } else {
      e1 = fmaf(m[p], th[p], e1);
    }
  }
  float value, dldf;
  family((m[NP] - (e0 + e1)) * m[NP + 1], m[NP + 1], value, dldf);
  if (LAST && d < N) val = val + value;
#pragma unroll
  for (int p = 0; p < NP; ++p) g[p] = fmaf(dldf, m[p], g[p]);
}

// One lane's share of a gradient: its rows d = lane + i T, the residual,
// the family's derivative, the gradient's partial sums g; at LAST also the
// value's terms of the rows below N. Each sum runs over RUN rows at a time
// and adds the run's sum to the lane's: a float32 sum over 64 rows in one
// run drifts from float64 faster than the plain version over 16
// transitions of a Cauchy chain.
template <bool LAST>
__device__ __forceinline__ void narrow_pass(const float4* __restrict__ Ms, int lane, int T,
                                            int n_rows, int N, const float (&th)[NP],
                                            float (&g)[NP], float& val) {
#pragma unroll
  for (int p = 0; p < NP; ++p) g[p] = 0.0f;
  for (int i0 = 0; i0 < n_rows; i0 += RUN) {
    float gr[NP], vr = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) gr[p] = 0.0f;
    const int i1 = min(n_rows, i0 + RUN);
#pragma unroll 2
    for (int i = i0; i < i1; ++i) narrow_row<LAST>(Ms, lane + i * T, N, th, gr, vr);
#pragma unroll
    for (int p = 0; p < NP; ++p) g[p] = g[p] + gr[p];
    if (LAST) val = val + vr;
  }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS, NARROW_BLOCKS_SM)
    hmc_model_narrow(const __grid_constant__ ModelArgs a) {
  extern __shared__ float4 smem4[];
  const int T = a.lanes, K = a.K, N = a.N, chunk = a.chunk, tid = threadIdx.x;
  const int lane = tid & (T - 1);
  const int k = blockIdx.x * (THREADS / T) + tid / T;
  const bool live = k < K;  // a lane of a chain past K takes part in the shuffles only
  const size_t Ks = static_cast<size_t>(K);
  const bool store = a.h_theta != nullptr;
  float4* Ms = smem4;
  float* vs = reinterpret_cast<float*>(Ms + size_t(a.rows) * NV);  // im, kind, a, b: NP each

  for (int q = tid; q < a.rows * NV; q += THREADS) cp_async16(Ms + q, a.M + q);
  cp_async_commit();
  for (int i = tid; i < 4 * NP; i += THREADS) vs[i] = a.vec[(i / NP) * VR + i % NP];
  const float norm = a.vec[4 * VR];
  // theta_o holds the chain's current position through the chunk, each
  // variable written by one lane of the chain and read back by all on a
  // rejection
  float th[NP], r[NP], g[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    th[p] = live ? a.theta[p * Ks + k] : 0.0f;
    if (live && (p & (T - 1)) == lane) a.theta_o[p * Ks + k] = th[p];
  }
  float lp = 0.0f, ev = 0.0f, ea = 0.0f, evr = 0.0f, it = 0.0f;
  int en = 0, ec = 0;
  if (live) {
    lp = a.logp[k];
    ev = a.ev[k];
    ea = a.ea[k];
    evr = a.evr[k];
    en = a.en[k];
    ec = a.ec[k];
    it = a.inv_temp[k];
  }
  cp_async_wait_all();
  __syncthreads();  // M and the per-variable words are in: the launch's only block barrier
  const float* im_s = vs;
  const float* kind_s = vs + NP;
  const float* pa_s = vs + 2 * NP;
  const float* pb_s = vs + 3 * NP;
  const int n_rows = a.rows / T;

  for (int t = 0; t < chunk; ++t) {
    const size_t at = size_t(t) * Ks + k;
    const int n = live ? step_count(a.us[at], a.steps, a.max_steps) : 0;
    const int nmax = __reduce_max_sync(0xffffffffu, n);  // the warp's chains step together
    const float rstep = it * ev, half = 0.5f * (it * ev);
    float kin0 = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float z = live ? a.z[(size_t(t) * NP + p) * Ks + k] : 0.0f;
      if (!UNIT) z = (1.0f / sqrtf(im_s[p])) * z;
      r[p] = z;
      kin0 = kin0 + z * velocity(im_s[p], z);
    }
    float lik = 0.0f;
    for (int s = 0; s <= nmax; ++s) {
      const bool moving = s <= n;
      if (s > 0 && moving) {
#pragma unroll
        for (int p = 0; p < NP; ++p) th[p] = th[p] + ev * velocity(im_s[p], r[p]);
      }
      float val = 0.0f;
      if (s == nmax) {
        narrow_pass<true>(Ms, lane, T, n_rows, N, th, g, val);
        lik = lanes_sum(val, T);
      } else {
        narrow_pass<false>(Ms, lane, T, n_rows, N, th, g, val);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) g[p] = lanes_sum(g[p], T);
      if (moving) {
        const float coef = (s == 0 || s == n) ? half : rstep;
        bool exp_out = false;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          exp_out |= static_cast<int>(kind_s[p]) == EXPONENTIAL && th[p] < 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float gp = prior_grad(g[p], static_cast<int>(kind_s[p]), pa_s[p], pb_s[p], th[p],
                                      exp_out);
          r[p] = r[p] + coef * gp;
        }
      }
    }

    // the transition's end, alike in every lane of the chain
    float kin = 0.0f, prior = 0.0f;
    int out = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kind = static_cast<int>(kind_s[p]);
      kin = kin + r[p] * velocity(im_s[p], r[p]);
      prior = prior + prior_value(kind, pa_s[p], pb_s[p], th[p]);
      out |= support(kind, pa_s[p], pb_s[p], th[p]);
    }
    if (out) prior = -INFINITY;
    const float h0 = 0.5f * kin0 - lp;
    const float pv = ((lik + prior) + norm) * it;
    const float h = 0.5f * kin - pv;
    const float ap = expf(h0 - h);
    adapt(ap, ev, ea, evr, en, ec);
    const bool accepted = live && ((ap >= 1.0f) || (a.ua[at] <= ap));  // duplicate-on-reject
    if (accepted) {
      lp = pv;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if ((p & (T - 1)) == lane) a.theta_o[p * Ks + k] = th[p];
    }
    __syncwarp();  // the lanes' writes of theta_o, before any lane reads it back
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (!accepted && live) th[p] = a.theta_o[p * Ks + k];
      if (store && live && (p & (T - 1)) == lane) a.h_theta[(size_t(t) * NP + p) * Ks + k] = th[p];
    }
    if (store && live && lane == 0) {
      a.h_logp[at] = lp;
      a.h_steps[at] = n;
      a.h_eps[at] = ev;
    }
  }
  if (live && lane == 0) {  // theta_o already holds the positions
    a.logp_o[k] = lp;
    a.ev_o[k] = ev;
    a.ea_o[k] = ea;
    a.evr_o[k] = evr;
    a.en_o[k] = en;
    a.ec_o[k] = ec;
  }
}

#else
// ---------------------------------------------------------------------------
// the wide route: a block of C chains, momenta in registers, M streamed
// ---------------------------------------------------------------------------

namespace {

constexpr int STAGES = 3;              // the ring of slabs of M
constexpr int TR = 8;                  // rows of a momentum (gradient) tile, by 4 chains
constexpr int RR = 4;                  // rows of a residual tile, by 4 chains
constexpr int NT = HM_TILES;           // momentum tiles a thread
// the products' unrolling, chosen by timing P = 256 (none with two tiles,
// whose momenta and gradients take 128 registers)
constexpr int UR = NT == 1 ? 2 : 1, UG = NT == 1 ? 4 : 1;
constexpr int TILE_VALUES = 8192;      // TR x 4 x THREADS: a block's momenta, one tile a thread
constexpr int CHAIN_WORDS = 13;        // per-chain words in shared memory

// Shared memory of a block in bytes (ops/hmc_model.py::_wide_smem computes
// the same): the ring, the positions, psi's two buffers, the residual's
// and the gradient's group sums, the owners' partial sums, the
// likelihood's and the chains' words.
size_t wide_smem(int rows, int chains, int slab, int ga, int gc) {
  const size_t words = size_t(STAGES) * slab * (rows + 4) + size_t(rows) * chains +
                       2 * size_t(slab) * chains + (ga > 1 ? size_t(ga) * slab * chains : 0) +
                       (gc > 1 ? size_t(gc - 1) * rows * chains : 0) +
                       3 * size_t(rows / TR) * chains + 4 * size_t(THREADS) +
                       CHAIN_WORDS * size_t(chains);
  return 4 * words;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS, 1)
    hmc_model_wide(const __grid_constant__ ModelArgs a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, PR = a.rows, PRS = a.stride, C = a.chains, S = a.slab;
  const int GA = a.ga, GC = a.gc;
  const int K = a.K, N = a.N, chunk = a.chunk, tid = threadIdx.x;
  const int CQ = C / 4;                          // groups of 4 chains
  const int NRQ = S / RR;                        // residual tiles down a slab
  const int NPT = PR / TR;                       // momentum tiles down the rows
  const int NS = (N + S - 1) / S;                // slabs a pass
  const int tiles_a = NRQ * CQ, tiles_c = NPT * CQ;
  const int PA = (PR / 4 + GA - 1) / GA * 4;     // columns of a residual group
  const int kb = blockIdx.x * C;                 // the block's first chain
  const size_t Ks = static_cast<size_t>(K);
  const size_t slab_words = size_t(S) * PRS;
  const bool store = a.h_theta != nullptr;

  float* ring = reinterpret_cast<float*>(smem4);
  float* Th = ring + STAGES * slab_words;         // positions, [row][chain]
  float* Psi = Th + size_t(PR) * C;               // 2 x [slab row][chain]
  float* Ebuf = Psi + 2 * size_t(S) * C;          // the residual's group sums
  float* Cbuf = Ebuf + (GA > 1 ? size_t(GA) * S * C : 0);  // the gradient's, groups 1 ..
  float* red = Cbuf + (GC > 1 ? size_t(GC - 1) * PR * C : 0);  // kin0, kin, prior: 3 x [row tile][chain]
  float* vred = red + 3 * size_t(NPT) * C;       // likelihood terms, 4 THREADS
  // per chain: the step size, the kick coefficients and the owner's state,
  // the step count, the accept flag and the support flags of two passes
  float* ev_s = vred + 4 * THREADS;
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
  int* flags = acc_s + C;                        // 2 C

  // the thread's gradient group and momentum tiles (owners: group 0): tile
  // tid and, with two tiles a thread (HM_TILES = 2, the tiles past the
  // threads), tile tid + THREADS, of the same chains as THREADS is a
  // multiple of CQ; a thread with no second tile repeats its first in the
  // products and keeps nothing of it
  const int tq = tid % tiles_c, gq = tid / tiles_c;
  const bool owner = gq == 0;
  const bool grads = gq < GC;
  const int c0 = 4 * (tq % CQ);
  int p0[NT];
  bool has[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int u = tq + q * THREADS;
    has[q] = owner && u < tiles_c;
    p0[q] = TR * ((has[q] ? u : tq) / CQ);
  }
  float r[NT][TR][4], acc[NT][TR][4];
  float val[4];  // the likelihood terms of chains 4 (tid % CQ) .. over the last pass
  // the per-variable words, read by the owners of their rows through L1:
  // the inverse mass, the prior's kind, a and b
  const float* vg = a.vec;
  auto im_of = [&](int p) { return __ldg(vg + p); };
  auto kind_of = [&](int p) { return static_cast<int>(__ldg(vg + PR + p)); };
  auto pa_of = [&](int p) { return __ldg(vg + 2 * PR + p); };
  auto pb_of = [&](int p) { return __ldg(vg + 3 * PR + p); };

  // the ring's first slab, then the state
  copy_rows(ring, a.M, 0, S, PRS);
  cp_async_commit();
  int issued = 1;  // slabs issued into the ring, counted over the chunk
  const float norm = a.vec[4 * PR];
  const int ko = kb + tid;
  float u_acc = 0.0f, u_next = 0.0f;
  if (tid < C) {  // a chain past K takes no step and kicks by 0
    n_s[tid] = 0;
    half_s[tid] = rstep_s[tid] = ev_s[tid] = 0.0f;
    flags[tid] = flags[C + tid] = 0;
    if (ko < K) {
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
  }
  __syncthreads();

  // Transition t's start, by each owner: the momentum draw (1 / sqrt(im)
  // z) of its tiles and their kinetic energy's partial sums, and the
  // support flags of the current positions into flag buffer fb.
  auto draw = [&](int t, int fb) {
    int bits[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (!has[q]) continue;
      float kin0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int p = p0[q] + i;
        const float im = im_of(p);
        const int kind = kind_of(p);
        const float4 tv = *reinterpret_cast<const float4*>(Th + p * C + c0);
        const float th[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kb + c0 + c;
          float z = 0.0f;
          if (p < P && k < K) {
            z = a.z[(size_t(t) * P + p) * Ks + k];
            if (!UNIT) z = (1.0f / sqrtf(im)) * z;
          }
          r[q][i][c] = z;
          kin0[c] = kin0[c] + z * velocity(im, z);
          bits[c] |= support(kind, pa_of(p), pb_of(p), th[c]);
        }
      }
      *reinterpret_cast<float4*>(red + (p0[q] / TR) * C + c0) =
          make_float4(kin0[0], kin0[1], kin0[2], kin0[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (bits[c]) atomicOr(flags + fb * C + c0 + c, bits[c]);
  };

  if (owner) {  // the positions into shared memory and theta_o, then the first draw
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (!has[q]) continue;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int p = p0[q] + i;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kb + c0 + c;
          const bool in = p < P && k < K;
          v[c] = in ? a.theta[p * Ks + k] : 0.0f;
          if (in) a.theta_o[p * Ks + k] = v[c];
        }
        *reinterpret_cast<float4*>(Th + p * C + c0) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    draw(0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  int sc = 0;    // the ring counter of the pass's first slab
  int pass = 0;  // passes over M, whose parity picks the support flags
  for (int t = 0; t < chunk; ++t) {
    int nmax = 0;
    for (int q = 0; q < C; ++q) nmax = max(nmax, n_s[q]);
    for (int s = 0; s <= nmax; ++s) {
      const bool last = s == nmax;
      const int* fl = flags + (pass & 1) * C;
      if (tid < C) flags[((pass + 1) & 1) * C + tid] = 0;  // the next pass's flags
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][i][c] = 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) val[c] = 0.0f;

      // psi of one slab row for 4 chains from their residuals e = M theta;
      // the row's y' and w sit in the ring row's words PR and PR + 1
      auto finish = [&](const float* Ms, int row, int cq, int ds, const float (&e)[4], float* psi) {
        const int d = ds * S + row;  // the datum
        const bool in = d < N;
        const float y = Ms[size_t(row) * PRS + PR], w = Ms[size_t(row) * PRS + PR + 1];
        float ps[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float value, dldf;
          family((y - e[c]) * w, w, value, dldf);
          ps[c] = in ? dldf : 0.0f;
          if (last && in) val[c] = val[c] + value;
        }
        *reinterpret_cast<float4*>(psi + row * C + 4 * cq) = make_float4(ps[0], ps[1], ps[2], ps[3]);
      };

      // The pass over M, pipelined: phase ph takes the residuals of slab
      // sc + ph (ph < NS) and the gradient product of slab sc + ph - 1 (ph > 0).
      for (int ph = 0; ph <= NS; ++ph) {
        const int cr = sc + ph, cg = cr - 1;
        const int hi = ph < NS ? cr : cg;  // the newest slab the phase reads
        if (issued == hi + 1) {  // its stage held slab hi - 2, done before the last barrier
          copy_rows(ring + size_t(issued % STAGES) * slab_words, a.M, (issued % NS) * S, S, PRS);
          cp_async_commit();
          ++issued;
        }
        if (ph < NS) {
          // the residuals: a tile is 4 rows (rq + NRQ i) by 4 chains, its
          // columns split in GA groups
          const float* Ms = ring + size_t(cr % STAGES) * slab_words;
          float* psi = Psi + size_t(cr & 1) * S * C;
          const int ds = cr % NS;
          for (int q = tid; q < tiles_a * GA; q += THREADS) {
            const int ta = q % tiles_a, g = q / tiles_a;
            const int cq = ta % CQ, rq = ta / CQ;
            const int pb = g * PA, pe = min(PR, pb + PA);
            const float* m0 = Ms + size_t(rq) * PRS;
            const size_t rs = size_t(NRQ) * PRS;
            // two sums, of the even and the odd column quads: the residual
            // feeds the family's derivative, whose roundoff the chains' drift
            // from float64 amplifies (one sum over 72 columns drifted
            // measurably faster than the plain version at P = 65)
            float e[RR][4], f[RR][4];
#pragma unroll
            for (int i = 0; i < RR; ++i) {
#pragma unroll
              for (int c = 0; c < 4; ++c) e[i][c] = f[i][c] = 0.0f;
            }
            auto quad = [&](int p, float (&x)[RR][4]) {
              float4 tv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                tv[i] = *reinterpret_cast<const float4*>(Th + (p + i) * C + 4 * cq);
#pragma unroll
              for (int i = 0; i < RR; ++i) {
                const float4 m = *reinterpret_cast<const float4*>(m0 + i * rs + p);
                x[i][0] = fmaf(m.x, tv[0].x, x[i][0]);
                x[i][1] = fmaf(m.x, tv[0].y, x[i][1]);
                x[i][2] = fmaf(m.x, tv[0].z, x[i][2]);
                x[i][3] = fmaf(m.x, tv[0].w, x[i][3]);
                x[i][0] = fmaf(m.y, tv[1].x, x[i][0]);
                x[i][1] = fmaf(m.y, tv[1].y, x[i][1]);
                x[i][2] = fmaf(m.y, tv[1].z, x[i][2]);
                x[i][3] = fmaf(m.y, tv[1].w, x[i][3]);
                x[i][0] = fmaf(m.z, tv[2].x, x[i][0]);
                x[i][1] = fmaf(m.z, tv[2].y, x[i][1]);
                x[i][2] = fmaf(m.z, tv[2].z, x[i][2]);
                x[i][3] = fmaf(m.z, tv[2].w, x[i][3]);
                x[i][0] = fmaf(m.w, tv[3].x, x[i][0]);
                x[i][1] = fmaf(m.w, tv[3].y, x[i][1]);
                x[i][2] = fmaf(m.w, tv[3].z, x[i][2]);
                x[i][3] = fmaf(m.w, tv[3].w, x[i][3]);
              }
            };
#pragma unroll UR
            for (int p = pb; p < pe; p += 8) {
              quad(p, e);
              if (p + 4 < pe) quad(p + 4, f);
            }
#pragma unroll
            for (int i = 0; i < RR; ++i) {
#pragma unroll
              for (int c = 0; c < 4; ++c) e[i][c] = e[i][c] + f[i][c];
            }
#pragma unroll
            for (int i = 0; i < RR; ++i) {
              const int row = rq + NRQ * i;
              if (GA == 1) {
                finish(Ms, row, cq, ds, e[i], psi);
              } else {
                *reinterpret_cast<float4*>(Ebuf + (size_t(g) * S + row) * C + 4 * cq) =
                    make_float4(e[i][0], e[i][1], e[i][2], e[i][3]);
              }
            }
          }
        }
        if (ph > 0 && grads) {
          // acc += M_slab^T psi on the thread's 8 x 4 tiles, over its group's rows
          const float* mg = ring + size_t(cg % STAGES) * slab_words;
          const float* psi = Psi + size_t(cg & 1) * S * C + c0;
#pragma unroll UG
          for (int j = gq; j < S; j += GC) {
            const float4 pv = *reinterpret_cast<const float4*>(psi + j * C);
            const float pc[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int q = 0; q < NT; ++q) {
              const float* mj = mg + size_t(j) * PRS + p0[q];
              const float4 m0 = *reinterpret_cast<const float4*>(mj);
              const float4 m1 = *reinterpret_cast<const float4*>(mj + 4);
              const float mv[TR] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
              for (int i = 0; i < TR; ++i) {
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[q][i][c] = fmaf(mv[i], pc[c], acc[q][i][c]);
              }
            }
          }
        }
        if (ph < NS) {
          if (GA > 1) {
            __syncthreads();  // the residual's group sums are whole
            const float* Ms = ring + size_t(cr % STAGES) * slab_words;
            float* psi = Psi + size_t(cr & 1) * S * C;
            const int ds = cr % NS;
            for (int q = tid; q < S * CQ; q += THREADS) {
              const int cq = q % CQ, row = q / CQ;
              float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              for (int g = 0; g < GA; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(Ebuf + (size_t(g) * S + row) * C + 4 * cq);
                e[0] = e[0] + v.x;
                e[1] = e[1] + v.y;
                e[2] = e[2] + v.z;
                e[3] = e[3] + v.w;
              }
              finish(Ms, row, cq, ds, e, psi);
            }
          }
          cp_async_wait_all();  // the next phase's slab is in
          __syncthreads();      // psi of slab cr is whole; every read of the phase is done
        }
      }
      sc += NS;

      // the pass's gradient, whole: the groups' partial sums in a fixed
      // order (one tile a thread: the plan takes groups only where the
      // tiles are fewer than the threads)
      if (GC > 1) {
        if (grads && !owner) {
          float* dst = Cbuf + size_t(gq - 1) * PR * C + c0;
#pragma unroll
          for (int i = 0; i < TR; ++i)
            *reinterpret_cast<float4*>(dst + (p0[0] + i) * C) =
                make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
        }
        __syncthreads();
        if (owner) {
          for (int g = 1; g < GC; ++g) {
            const float* src = Cbuf + size_t(g - 1) * PR * C + c0;
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float4 v = *reinterpret_cast<const float4*>(src + (p0[0] + i) * C);
              acc[0][i][0] = acc[0][i][0] + v.x;
              acc[0][i][1] = acc[0][i][1] + v.y;
              acc[0][i][2] = acc[0][i][2] + v.z;
              acc[0][i][3] = acc[0][i][3] + v.w;
            }
          }
        }
      }

      if (owner) {
        // the kick r + coef (g + the prior's term); at the last step the
        // kinetic energy's and the prior's partial sums; then the next
        // step's drift and the support flags of its positions
        float coef[4], ev[4];
        bool moving[4], next[4], exp_out[4];
        int bits[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ch = c0 + c, nc = n_s[ch];
          moving[c] = s <= nc;
          next[c] = !last && s + 1 <= nc;
          coef[c] = (s == 0 || s == nc) ? half_s[ch] : rstep_s[ch];
          ev[c] = ev_s[ch];
          exp_out[c] = (fl[ch] & EXP_OUT) != 0;
        }
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          if (!has[q]) continue;
          float kin[4] = {0.0f, 0.0f, 0.0f, 0.0f}, prior[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const int p = p0[q] + i;
            const int kind = kind_of(p);
            const float im = im_of(p), pa = pa_of(p), pb = pb_of(p);
            float4* tp = reinterpret_cast<float4*>(Th + p * C + c0);
            const float4 tv = *tp;
            float th[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (moving[c])
                r[q][i][c] = r[q][i][c] +
                             coef[c] * prior_grad(acc[q][i][c], kind, pa, pb, th[c], exp_out[c]);
              if (last) {
                kin[c] = kin[c] + r[q][i][c] * velocity(im, r[q][i][c]);
                prior[c] = prior[c] + prior_value(kind, pa, pb, th[c]);
              }
              if (next[c]) th[c] = th[c] + ev[c] * velocity(im, r[q][i][c]);
              bits[c] |= support(kind, pa, pb, th[c]);
            }
            if (!last) *tp = make_float4(th[0], th[1], th[2], th[3]);
          }
          if (last) {
            *reinterpret_cast<float4*>(red + (NPT + p0[q] / TR) * C + c0) =
                make_float4(kin[0], kin[1], kin[2], kin[3]);
            *reinterpret_cast<float4*>(red + (2 * NPT + p0[q] / TR) * C + c0) =
                make_float4(prior[0], prior[1], prior[2], prior[3]);
          }
        }
        if (!last) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (bits[c]) atomicOr(flags + ((pass + 1) & 1) * C + c0 + c, bits[c]);
        }
      }
      if (last) {
        const int slot = tid / CQ;  // the thread's rows are all of chains 4 (tid % CQ) ..
        *reinterpret_cast<float4*>(vred + slot * C + 4 * (tid % CQ)) =
            make_float4(val[0], val[1], val[2], val[3]);
      }
      ++pass;
      __syncthreads();  // the next pass's positions and flags; the transition's partial sums
    }

    // The transition's end, by each chain's owner thread: the sums in a
    // fixed order, the energies, the acceptance and the adaptation.
    const bool more = t + 1 < chunk;
    if (tid < C && ko < K) {
      const float lik = row_sum(vred + tid, 4 * THREADS / C, C);
      const float kin0 = row_sum(red + tid, NPT, C);
      const float kin = row_sum(red + NPT * C + tid, NPT, C);
      const int out = flags[((pass - 1) & 1) * C + tid];
      const float prior = (out & (EXP_OUT | UNI_OUT)) ? -INFINITY
                                                      : row_sum(red + 2 * NPT * C + tid, NPT, C);
      float lp = lp_s[tid], ev = ev_s[tid], ea = ea_s[tid], evr = evr_s[tid];
      int en = en_s[tid], ec = ec_s[tid];
      const float it = it_s[tid];
      const float h0 = 0.5f * kin0 - lp;
      const float p = ((lik + prior) + norm) * it;
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
    // is restored; the history; the next transition's draw
    if (owner) {
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        if (!has[q]) continue;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int p = p0[q] + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = kb + c0 + c;
            if (p < P && k < K) {
              const size_t at = p * Ks + k;
              float* th = Th + p * C + c0 + c;
              if (acc_s[c0 + c]) {
                a.theta_o[at] = *th;
              } else {
                *th = a.theta_o[at];
              }
              if (store) a.h_theta[size_t(t) * P * Ks + at] = *th;
            }
          }
        }
      }
      if (more) draw(t + 1, pass & 1);
    }
    __syncthreads();
  }
  cp_async_wait_all();  // the ring's last prefetch
  if (tid < C && ko < K) {  // theta_o already holds the positions
    a.logp_o[ko] = lp_s[tid];
    a.ev_o[ko] = ev_s[tid];
    a.ea_o[ko] = ea_s[tid];
    a.evr_o[ko] = evr_s[tid];
    a.en_o[ko] = en_s[tid];
    a.ec_o[ko] = ec_s[tid];
  }
}
#endif

// Launches one chunk on `stream` through this library's route and returns
// a CUDA error code (0 on success; cudaErrorInvalidValue for a plan the
// route does not take or a mass or P that is not this library's). Every
// pointer is a device pointer; inv_mass is folded into vec (all ones for
// unit mass), and the four history pointers are all null (no history) or
// all set.
extern "C" int hmc_model_chunk(
    const float* theta, const float* logp, const float* ev, const float* ea, const float* evr,
    const int* en, const int* ec, const float* inv_temp, const float* z, const float* us,
    const float* ua, const float* M, const float* vec,
    float* theta_o, float* logp_o, float* ev_o, float* ea_o, float* evr_o, int* en_o, int* ec_o,
    float* h_theta, float* h_logp, int* h_steps, float* h_eps, int n_params, int K, int N,
    int chunk, int steps, int max_steps, int chains, int lanes, int rows, int stride, int slab,
    int ga, int gc, int unit, void* stream) {
  if (n_params < 1 || K < 1 || N < 1 || chunk < 1 || (unit != 0) != UNIT)
    return static_cast<int>(cudaErrorInvalidValue);
#if HM_P > 0
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (n_params != NP || !pow2 || chains != THREADS / lanes || rows < N || rows % NARROW_ROWS != 0 ||
      stride != NW || slab != 0 || ga != 0 || gc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = narrow_smem(rows, NP);
  void (*kernel)(ModelArgs) = hmc_model_narrow;
#else
  const bool pow2 = chains >= 4 && chains <= 64 && (chains & (chains - 1)) == 0;
  const bool slab_ok = slab >= RR && slab <= 256 && (slab & (slab - 1)) == 0;
  // two tiles a thread only where one does not hold the block's momenta
  if (!pow2 || !slab_ok || lanes != 0 || rows % TR != 0 || rows < n_params || stride != rows + 4 ||
      rows * chains > NT * TILE_VALUES || (NT == 2 && rows * chains <= TILE_VALUES))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_a = slab / RR * (chains / 4), tiles_c = rows / TR * (chains / 4);
  if (ga < 1 || 4 * ga > rows || tiles_a * ga > (tiles_a > THREADS ? tiles_a : THREADS) || gc < 1 || gc > slab ||
      tiles_c * gc > NT * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem(rows, chains, slab, ga, gc);
  void (*kernel)(ModelArgs) = hmc_model_wide;
#endif
  if (smem > SMEM_BLOCK) return static_cast<int>(cudaErrorInvalidValue);
  ModelArgs args{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua,
                 reinterpret_cast<const float4*>(M), vec,
                 theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
                 h_theta, h_logp, h_steps, h_eps,
                 n_params, K, N, chunk, steps, max_steps, chains, lanes, rows, stride, slab, ga, gc};
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (K + chains - 1) / chains;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
