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
// its box). The normalisation constants of every part join the value.
// The library is built once per likelihood family (HM_FAMILY: 0 Gaussian,
// 1 Cauchy, 2 Logistic) and kind of mass (HM_UNIT: 1 unit, 0 diagonal).
//
// What bounds it on this card. Each leapfrog step needs the gradient at a
// new position: two products with M, r = M theta (N x P by P x chains)
// and M^T psi, 4 N P flops a chain, plus N elementwise terms. Per byte of
// normals streamed (4 P a transition and chain) that is N x steps flops
// (20,480 at N = 1,024 and 20 steps), so at any useful N the kernel is
// bound by FP32 FFMA issue (67 TFLOP/s), not by device memory. M is the same for every chain, so a
// block of C chains reads each value of M it stages once for C chains.
//
// What the design does about it (a first design, right and simple; see
// PERF.md for its time against its bound):
//   - A block of 256 threads owns C chains (a power of two, 4 to 64, from
//     ops/hmc_model.py::model_plan). Their positions and momenta (P rounded
//     up to 8 rows by C, [row][chain]) live in shared memory for the whole
//     chunk; the current position of each chain waits in theta_o.
//   - One gradient is one pass over M in slabs of S rows, each staged by
//     cp.async into a ring of two stages (the next slab in flight while the
//     current one is used). Per slab: the residuals of the slab's rows for
//     the block's chains (a thread's tile is one row by four chains, float4
//     reads of M and the positions), the family's derivative times the
//     inverse scale times the chain's kick coefficient (psi), then r +=
//     M_slab^T psi on tiles of 8 rows by 4 chains. Where a product has fewer
//     tiles than threads, its contraction is split over GA (residual) or GC
//     (gradient) groups whose partial sums are added in a fixed order.
//   - The kick coefficient is folded into psi, so the pass adds the kick to
//     the momentum directly and no gradient is stored. A chain past its own
//     step count is frozen (no drift, coefficient 0) until the block's
//     largest count, as kernel B1's wide route does.
//   - The pass at the block's last step is at every chain's proposal: it
//     also sums the likelihood's terms, per thread over the slabs and then
//     by the chain's owner thread in a fixed order.
// FP32 throughout with fmaf for the products, no TF32. The sums round in
// another order than the plain version's, so the kernel agrees with it
// within float32 roundoff, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hmc_common.cuh"  // adapt, step_count, the cp.async ring, row_sum

#if !defined(HM_FAMILY) || !defined(HM_UNIT)
#error "the model route is built per family and mass: nvcc -DHM_FAMILY=<0|1|2> -DHM_UNIT=<0|1>"
#endif

constexpr int FAMILY = HM_FAMILY;  // 0 Gaussian, 1 Cauchy, 2 Logistic
constexpr bool UNIT = HM_UNIT != 0;
static_assert(FAMILY >= 0 && FAMILY <= 2, "HM_FAMILY is 0, 1 or 2");

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
  // the model, zero padded (ops/hmc_model.py::model_operands)
  const float4* M;        // (N rounded up to S, rows) row major
  const float* yo;        // (N rounded up to S,) y - offset
  const float* w;         // (N rounded up to S,) inverse scales
  const float* vec;       // 4 rows + 1: inverse mass, prior kind, prior a, prior b, normalisation
  // state out; theta_o holds each chain's current position through the chunk
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
  // the plan (ops/hmc_model.py::model_plan): rows = P rounded up to 8,
  // chains per block, data rows per slab, the residual's and the
  // gradient's contraction groups
  int rows, chains, slab, ga, gc;
};

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 2;              // the ring of slabs of M
constexpr int TR = 8;                  // rows of a gradient tile (by 4 chains)
constexpr size_t SMEM_BLOCK = 232448;  // the 227 KB a block may have
constexpr int CHAIN_WORDS = 13;        // per-chain words in shared memory (see the kernel)
// the prior's kinds, as ops/hmc_model.py writes them into vec
constexpr int GAUSSIAN = 1, EXPONENTIAL = 2, UNIFORM = 3;
// a chain's support flags: an Exponential variable below 0, a Uniform one
// outside its box
constexpr int EXP_OUT = 1, UNI_OUT = 2;

// Shared memory of a block in bytes (ops/hmc_model.py::_model_smem
// computes the same): the ring, the positions and momenta, psi, the
// groups' partial sums, the model's per-row words, the partial sums of the
// transition's end and the chains' words.
size_t model_smem(int rows, int chains, int slab, int ga, int gc) {
  const size_t words = size_t(STAGES) * slab * rows + 2 * size_t(rows) * chains +
                       size_t(slab) * chains + (ga > 1 ? size_t(ga) * slab * chains : 0) +
                       (gc > 1 ? size_t(gc) * rows * chains : 0) + 4 * size_t(rows) +
                       7 * size_t(THREADS) + CHAIN_WORDS * size_t(chains);
  return 4 * words;
}

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

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS)
    hmc_model_kernel(const __grid_constant__ ModelArgs a) {
  extern __shared__ float4 smem4[];
  const int P = a.P, PR = a.rows, C = a.chains, S = a.slab, GA = a.ga, GC = a.gc;
  const int K = a.K, N = a.N, chunk = a.chunk, tid = threadIdx.x;
  const int CQ = C / 4;                          // groups of 4 chains
  const int NS = (N + S - 1) / S;                // slabs a pass
  const int tiles_a = S * CQ, tiles_c = (PR / TR) * CQ;
  const int PA = (PR / 4 + GA - 1) / GA * 4;     // columns of a residual group
  const int SC = (S + GC - 1) / GC;              // rows of a gradient group
  const int kb = blockIdx.x * C;                 // the block's first chain
  const size_t Ks = static_cast<size_t>(K);
  const bool store = a.h_theta != nullptr;

  float* ring = reinterpret_cast<float*>(smem4);
  float* Th = ring + size_t(STAGES) * S * PR;    // positions, [row][chain]
  float* Rm = Th + size_t(PR) * C;               // momenta, [row][chain]
  float* Psi = Rm + size_t(PR) * C;              // [slab row][chain]
  float* Ebuf = Psi + size_t(S) * C;             // the residual's group sums
  float* Cbuf = Ebuf + (GA > 1 ? size_t(GA) * S * C : 0);  // the gradient's
  float* im_s = Cbuf + (GC > 1 ? size_t(GC) * PR * C : 0);
  float* kind_s = im_s + PR;
  float* pa_s = kind_s + PR;
  float* pb_s = pa_s + PR;
  float* vred = pb_s + PR;                       // likelihood terms, 4 THREADS
  float* red = vred + 4 * THREADS;               // kin0, kin, prior terms, THREADS each
  // per chain: the step size, the kick coefficients and the owner's state,
  // the step count, the accept flag and the support flags of two passes
  float* ev_s = red + 3 * THREADS;
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

  // the ring's first slab, then the model's per-row words and the state
  for (int s = 0; s < STAGES - 1; ++s) {
    copy_rows(ring + size_t(s) * S * PR, a.M, (s % NS) * S, S, PR);
    cp_async_commit();
  }
  for (int i = tid; i < 4 * PR; i += THREADS) im_s[i] = a.vec[i];  // im, kind, pa, pb
  const float norm = a.vec[4 * PR];
  const int ce = tid % C;  // the thread's chain in every elementwise stage (C divides THREADS)
  const int ke = kb + ce;
  for (int q = tid; q < PR * C; q += THREADS) {
    const int p = q / C;
    const bool in = p < P && ke < K;
    const float v = in ? a.theta[p * Ks + ke] : 0.0f;
    Th[q] = v;
    Rm[q] = 0.0f;
    if (in) a.theta_o[p * Ks + ke] = v;
  }
  const int ko = kb + tid;
  const bool owner = tid < C && ko < K;
  float u_acc = 0.0f, u_next = 0.0f;
  if (tid < C) {  // a chain past K takes no step and kicks by 0
    n_s[tid] = 0;
    half_s[tid] = rstep_s[tid] = ev_s[tid] = 0.0f;
    flags[tid] = flags[C + tid] = 0;
  }
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
  __syncthreads();

  int slab = 0;  // slabs of M consumed
  int pass = 0;  // passes over M, whose parity picks the support flags
  for (int t = 0; t < chunk; ++t) {
    int nmax = 0;
    for (int q = 0; q < C; ++q) nmax = max(nmax, n_s[q]);
    const int nce = n_s[ce];
    const float eve = ev_s[ce];
    for (int s = 0; s <= nmax; ++s) {
      int* fl = flags + (pass & 1) * C;
      // Step 0 draws the momentum (1 / sqrt(im) z) and sums its kinetic
      // energy; a later step drifts the chains still moving. Then the
      // support flags of the positions.
      int bits = 0;
      float kin0 = 0.0f;
      for (int q = tid; q < PR * C; q += THREADS) {
        const int p = q / C;
        const float im = im_s[p];
        float th = Th[q];
        if (s == 0) {
          float r = 0.0f;
          if (p < P && ke < K) {
            r = a.z[(size_t(t) * P + p) * Ks + ke];
            if (!UNIT) r = (1.0f / sqrtf(im)) * r;
          }
          Rm[q] = r;
          kin0 = kin0 + r * velocity(im, r);
        } else if (s <= nce) {
          th = th + eve * velocity(im, Rm[q]);
          Th[q] = th;
        }
        const int kind = static_cast<int>(kind_s[p]);
        if (kind == EXPONENTIAL && th < 0.0f) bits |= EXP_OUT;
        if (kind == UNIFORM && !(pa_s[p] <= th && th <= pb_s[p])) bits |= UNI_OUT;
      }
      if (bits) atomicOr(fl + ce, bits);
      if (s == 0) red[tid] = kin0;
      __syncthreads();

      // the pass over M: r += coef M^T psi; at the last step, the value terms
      const bool last = s == nmax;
      float val[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int sl = 0; sl < NS; ++sl, ++slab) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // slab `slab` is in; every thread is done with the stage refilled next
        const int next = slab + STAGES - 1;
        copy_rows(ring + size_t(next % STAGES) * S * PR, a.M, (next % NS) * S, S, PR);
        cp_async_commit();
        const float* Ms = ring + size_t(slab % STAGES) * S * PR;

        // psi of one tile (a slab row, 4 chains) from its residuals e = M theta
        auto finish = [&](int row, int cq, const float (&e)[4]) {
          const int d = sl * S + row;  // the datum
          const bool in = d < N;
          const float y = in ? a.yo[d] : 0.0f, w = in ? a.w[d] : 0.0f;
          float ps[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ch = 4 * cq + c;
            const int nc = n_s[ch];
            float value, dldf;
            family((y - e[c]) * w, w, value, dldf);
            const float coef = (s == 0 || s == nc) ? half_s[ch] : rstep_s[ch];
            ps[c] = (in && s <= nc) ? coef * dldf : 0.0f;
            if (last && in) val[c] = val[c] + value;
          }
          *reinterpret_cast<float4*>(Psi + row * C + 4 * cq) = make_float4(ps[0], ps[1], ps[2], ps[3]);
        };

        // the residuals: a tile is a slab row by 4 chains, its columns split in GA groups
        for (int q = tid; q < tiles_a * GA; q += THREADS) {
          const int tile = q % tiles_a, g = q / tiles_a;
          const int cq = tile % CQ, row = tile / CQ;
          const int p_end = min(PR, (g + 1) * PA);
          const float* mrow = Ms + size_t(row) * PR;
          float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
          for (int p = g * PA; p < p_end; p += 4) {
            const float4 m = *reinterpret_cast<const float4*>(mrow + p);
            const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 th = *reinterpret_cast<const float4*>(Th + (p + i) * C + 4 * cq);
              e[0] = fmaf(mv[i], th.x, e[0]);
              e[1] = fmaf(mv[i], th.y, e[1]);
              e[2] = fmaf(mv[i], th.z, e[2]);
              e[3] = fmaf(mv[i], th.w, e[3]);
            }
          }
          if (GA == 1) {
            finish(row, cq, e);
          } else {
            *reinterpret_cast<float4*>(Ebuf + (size_t(g) * S + row) * C + 4 * cq) =
                make_float4(e[0], e[1], e[2], e[3]);
          }
        }
        if (GA > 1) {
          __syncthreads();
          for (int q = tid; q < tiles_a; q += THREADS) {
            const int cq = q % CQ, row = q / CQ;
            float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int g = 0; g < GA; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(Ebuf + (size_t(g) * S + row) * C + 4 * cq);
              e[0] = e[0] + v.x;
              e[1] = e[1] + v.y;
              e[2] = e[2] + v.z;
              e[3] = e[3] + v.w;
            }
            finish(row, cq, e);
          }
        }
        __syncthreads();  // psi is whole

        // r += M_slab^T psi: a tile is 8 rows by 4 chains, its slab rows split in GC groups
        for (int q = tid; q < tiles_c * GC; q += THREADS) {
          const int tile = q % tiles_c, g = q / tiles_c;
          const int cq = tile % CQ, p0 = TR * (tile / CQ);
          const int s_end = min(S, (g + 1) * SC);
          float acc[TR][4];
#pragma unroll
          for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
          }
#pragma unroll 2
          for (int j = g * SC; j < s_end; ++j) {
            const float4 m0 = *reinterpret_cast<const float4*>(Ms + size_t(j) * PR + p0);
            const float4 m1 = *reinterpret_cast<const float4*>(Ms + size_t(j) * PR + p0 + 4);
            const float4 pv = *reinterpret_cast<const float4*>(Psi + j * C + 4 * cq);
            const float mv[TR] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
            const float pc[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int i = 0; i < TR; ++i) {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(mv[i], pc[c], acc[i][c]);
            }
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            float* dst = (GC == 1 ? Rm : Cbuf + size_t(g) * PR * C) + (p0 + i) * C + 4 * cq;
            float4 v = GC == 1 ? *reinterpret_cast<float4*>(dst) : make_float4(0.f, 0.f, 0.f, 0.f);
            v.x = v.x + acc[i][0];
            v.y = v.y + acc[i][1];
            v.z = v.z + acc[i][2];
            v.w = v.w + acc[i][3];
            *reinterpret_cast<float4*>(dst) = v;
          }
        }
        if (GC > 1) {
          __syncthreads();
          for (int q = tid; q < PR * CQ; q += THREADS) {
            const int cq = q % CQ, p = q / CQ;
            float4* dst = reinterpret_cast<float4*>(Rm + p * C + 4 * cq);
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int g = 0; g < GC; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(Cbuf + (size_t(g) * PR + p) * C + 4 * cq);
              sum.x = sum.x + v.x;
              sum.y = sum.y + v.y;
              sum.z = sum.z + v.z;
              sum.w = sum.w + v.w;
            }
            float4 r = *dst;
            r.x = r.x + sum.x;
            r.y = r.y + sum.y;
            r.z = r.z + sum.z;
            r.w = r.w + sum.w;
            *dst = r;
          }
        }
      }
      __syncthreads();  // the momenta are whole

      // the prior's kick; at the last step the kinetic energy and the
      // prior's terms, per thread, and the likelihood's terms
      const bool moving = s <= nce;
      const float coef = (s == 0 || s == nce) ? half_s[ce] : rstep_s[ce];
      const bool exp_out = (fl[ce] & EXP_OUT) != 0;
      float kin = 0.0f, prior = 0.0f;
      for (int q = tid; q < PR * C; q += THREADS) {
        const int p = q / C;
        const int kind = static_cast<int>(kind_s[p]);
        const float th = Th[q];
        float r = Rm[q];
        if (moving && kind == GAUSSIAN) r = r + coef * (((pa_s[p] - th) * pb_s[p]) * pb_s[p]);
        if (moving && kind == EXPONENTIAL && !exp_out) r = r + coef * (-pa_s[p]);
        Rm[q] = r;
        if (last) {
          kin = kin + r * velocity(im_s[p], r);
          if (kind == GAUSSIAN) {
            const float zp = (pa_s[p] - th) * pb_s[p];
            prior = prior + (-0.5f * (zp * zp));
          } else if (kind == EXPONENTIAL) {
            prior = prior + (-(pa_s[p] * th));
          }
        }
      }
      if (last) {
        red[THREADS + tid] = kin;
        red[2 * THREADS + tid] = prior;
        const int slot = tid / CQ;  // the thread's residual tiles are all of chains 4 (tid % CQ) ..
        *reinterpret_cast<float4*>(vred + slot * C + 4 * (tid % CQ)) =
            make_float4(val[0], val[1], val[2], val[3]);
      }
      if (tid < C) flags[((pass + 1) & 1) * C + tid] = 0;  // the next pass's flags
      ++pass;
      __syncthreads();
    }

    // The transition's end, by each chain's owner: the sums in a fixed
    // order, the energies, the acceptance and the adaptation.
    const bool more = t + 1 < chunk;
    if (owner) {
      const float lik = row_sum(vred + tid, 4 * THREADS / C, C);
      const float kin0 = row_sum(red + tid, THREADS / C, C);
      const float kin = row_sum(red + THREADS + tid, THREADS / C, C);
      const int out = flags[((pass - 1) & 1) * C + tid];
      const float prior = (out & (EXP_OUT | UNI_OUT)) ? -INFINITY
                                                      : row_sum(red + 2 * THREADS + tid, THREADS / C, C);
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
    // is restored; then the history
    const bool accepted = acc_s[ce] != 0;
    for (int q = tid; q < PR * C; q += THREADS) {
      const int p = q / C;
      if (p < P && ke < K) {
        const size_t at = p * Ks + ke;
        if (accepted) {
          a.theta_o[at] = Th[q];
        } else {
          Th[q] = a.theta_o[at];
        }
        if (store) a.h_theta[size_t(t) * P * Ks + at] = Th[q];
      }
    }
  }
  cp_async_wait_all();  // the ring's last prefetch
  if (owner) {  // theta_o already holds the positions
    a.logp_o[ko] = lp_s[tid];
    a.ev_o[ko] = ev_s[tid];
    a.ea_o[ko] = ea_s[tid];
    a.evr_o[ko] = evr_s[tid];
    a.en_o[ko] = en_s[tid];
    a.ec_o[ko] = ec_s[tid];
  }
}

// Launches one chunk on `stream` and returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for a plan this kernel does not take or
// a mass that is not this library's). Every pointer is a device pointer;
// inv_mass is folded into vec (all ones for unit mass), and the four
// history pointers are all null (no history) or all set.
extern "C" int hmc_model_chunk(
    const float* theta, const float* logp, const float* ev, const float* ea, const float* evr,
    const int* en, const int* ec, const float* inv_temp, const float* z, const float* us,
    const float* ua, const float* M, const float* yo, const float* w, const float* vec,
    float* theta_o, float* logp_o, float* ev_o, float* ea_o, float* evr_o, int* en_o, int* ec_o,
    float* h_theta, float* h_logp, int* h_steps, float* h_eps, int n_params, int K, int N,
    int chunk, int steps, int max_steps, int rows, int chains, int slab, int ga, int gc,
    int unit, void* stream) {
  const bool pow2 = chains >= 4 && chains <= 64 && (chains & (chains - 1)) == 0;
  if (n_params < 1 || K < 1 || N < 1 || chunk < 1 || !pow2 || rows % TR != 0 || rows < n_params ||
      slab < 1 || ga < 1 || 4 * ga > rows || gc < 1 || gc > slab || (unit != 0) != UNIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = model_smem(rows, chains, slab, ga, gc);
  if (smem > SMEM_BLOCK) return static_cast<int>(cudaErrorInvalidValue);
  ModelArgs args{theta, logp, ev, ea, evr, en, ec, inv_temp, z, us, ua,
                 reinterpret_cast<const float4*>(M), yo, w, vec,
                 theta_o, logp_o, ev_o, ea_o, evr_o, en_o, ec_o,
                 h_theta, h_logp, h_steps, h_eps,
                 n_params, K, N, chunk, steps, max_steps, rows, chains, slab, ga, gc};
  cudaError_t err = cudaFuncSetAttribute(hmc_model_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (K + chains - 1) / chains;
  hmc_model_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
