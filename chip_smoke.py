"""Drive the PyTorch port's main paths once on one CUDA GPU: batched HMC
(kernel B1), dense GP regression (kernel B2), the matrix-free
small-noise GP (kernels B3-B8) and the probes P1-P3 that measure B3.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. device: a CUDA device is required; prints its name, the device count
   and ``nvidia-smi``'s name and power limit;
2. build: compiles kernels B1 (``inference_tpu_torch/ops/csrc/hmc_fused.cu``),
   B2 (``.../sqexp.cu``), B3/B4 (``.../sqexp_fused.cu``), B5/B7
   (``.../sqexp_entries.cu``), B6/B8 (``.../sqexp_stored.cu``) and the
   probes P1 (``.../issue_probe.cu``), P2 (``.../sqexp_ablate.cu``) and P3
   (``.../sqexp_words_mma.cu``) with nvcc, one process each, started
   together; times each build and prints the ``-Xptxas -v`` registers and
   spills;
3. kernel against plain version, on the card, in float32, on the same
   random draws: (a) P=10, K=65,536, one transition; (b) the same with
   64 transitions and the history; (c) P=32, diagonal mass, inv_temp 0.5,
   K=4,096. Then both are timed on one chunk of the main path's shape;
4. main path: ``ChainArray("hmc", GaussianForm, ..., fused=True)`` on the
   10-dim correlated Gaussian of ``bench.py`` at 65,536 chains: warm-up,
   a timed advance, a stored advance for the acceptance and a thinned one
   for the mixing checks; checks the launch count, the sample variances
   and R-hat;
5. plain path: the same ChainArray with ``fused=False``, timed;
6. kernel B2 against its plain version on the card, on the same inputs:
   float64 and float32 at 16,384 x 16,384 (D=2, gp-16k's data), a ragged
   float64 case (3,001 x 2,500, D=5), and the autograd backward against
   autograd of the plain version at N=4,096; then both timed at
   16,384 x 16,384 in each dtype, beside ``torch.cdist`` and the exp;
7. GP main path (gp-16k): ``GpRegressor`` on ``benchmarks/gp_lml_bench.py``'s
   data and hyperparameters at N=16,384 in float64: LML+gradient
   evaluations per second and peak memory, the B2 launch count, the LML
   against an independent plain route (1e-10) and the gradient against
   central finite differences (1e-5); a ``torch.profiler`` breakdown of
   one evaluation (device time by operation, device idle share); the same
   with ``cholesky="analytic"``; one float32 evaluation;
8. GP fit and prediction at N=4,096 in float64: ``fit(optimizer="bfgs",
   n_starts=2)``, then ``__call__`` at 4,096 points against the plain
   route (1e-10);
9. kernels B3-B8 against their plain versions at full width, n = 53,248
   (gp-large-50k's padded data): B5 and B7 equal bit for bit, row block by
   row block; B3, B4 (q = 1, 8), B6 and B8 (q = 1, 2, 8) within 1e-13 of
   sum_j |E_ij| |V_jk|; B6 against B4 on the same V, B8 against B6 within
   the float32 store's 2^-24; then each timed with CUDA events beside its
   plain version, B6 beside ``torch.matmul``;
10. matrix-free GP main path (gp-large-50k): ``LargeScaleGP(solver="df64")``
    on ``benchmarks/df64_solve_bench.py``'s data at N=50,000 (sigma=0.01,
    rank 512, block 4096, cg_tol 1e-9) with ``store_entries="auto"`` (B5,
    then B6 in every iteration), ``False`` (B3 in every iteration) and
    ``"f32"`` (B7, then B8 in every iteration and B3 in every refresh):
    cold constructor and warm solve, chunks and iterations, the FP64
    residual by the port's kernel and by an independent plain route
    (<= 1e-9), 256 means and 16 variances (B6, B4 or B8 with q = 8), peak
    memory, launches per kernel, and a ``torch.profiler`` breakdown of one
    warm solve with each store;
11. gp-large-16k: the same at N=16,384 against a dense FP64 Cholesky on
    the card: the training solve (1e-8 of max |alpha|), means (1e-6) and
    variances (1e-9) at 16 points;
12. the probes at full width, n = 53,248, d = 2 (their own U[0, 10]^2
    generator, the distribution of gp-large-50k's coordinates): P1 bit for
    bit against its plain version in float32 and float64, every mode and
    chain count; every P2 variant against its plain version (1e-13 of
    sum|term||w|, d2exp32 1e-6, and again on coordinates shifted by 1e4,
    where a float32-distance control must fail that limit); P3's class
    sums on one 16 x 8 tile exactly, its matvec against its plain version
    (1e-13) and B3 (1e-11).
    Then each probe's own entry point, its launch count set to 0 before and
    read after: P1 under ``nvidia-smi``'s SM clock and power readings, every
    configuration timed with its bound; the SASS instruction mix of the hot
    loops of B3, P2 and P3 with the issue bounds it sets; P2 every
    variant and B3; P3 beside B3 and against the float64 truth; then the
    plain versions timed.

The second-to-last lines are a JSON object describing the kernels (each
with its bound, plain version and library call) and the ``nvidia-smi``
line; the last line is ``{"ok": true, "device": {...}}``.
"""

import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from inference_tpu_torch.gp import GpRegressor, LargeScaleGP
from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import _build, df64, hmc_fused, pairwise
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.probes import (EXP_FLOPS, FP32_FLOPS, FP64_FLOPS, bound, df64_ablate,
                                        time_events, vpu_probe)
from inference_tpu_torch.probes import df64_mxu_d2_experiment as words

N_DIM = 10
N_CHAINS = 65_536
HMC_STEPS = 50
RTOL, ATOL = 1e-4, 1e-5  # per-chain kernel-vs-plain tolerance in float32
MIN_AGREE = 0.999        # share of chains that must agree

def make_cov():
    """The covariance of ``bench.py``'s 10-dim correlated Gaussian."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    return A @ A.T + np.eye(N_DIM)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] {name}, device count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


KERNELS = {"hmc_fused": "B1", "sqexp": "B2", "sqexp_fused": "B3/B4", "sqexp_entries": "B5/B7",
           "sqexp_stored": "B6/B8", "issue_probe": "P1", "sqexp_ablate": "P2",
           "sqexp_words_mma": "P3"}


def _timed_build(name):
    cached = _build.library_path(name).exists()
    t0 = time.perf_counter()
    _build.load(name)
    return cached, time.perf_counter() - t0


def phase_build():
    """Build every kernel, one nvcc process each, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(_timed_build, name) for name in KERNELS}
        results = {name: f.result() for name, f in futures.items()}
    for name, (cached, seconds) in results.items():
        print(f"[build] kernel {KERNELS[name]} {'loaded from cache' if cached else 'built'} "
              f"in {seconds:.2f} s: {_build.library_path(name).name}")
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"[build] {line.strip()}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    _print_fp64_mix()


@functools.lru_cache(maxsize=None)
def _sass(name):
    """The SASS of ``name``'s library by cuobjdump, or None without it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120).stdout


def _print_fp64_mix():
    """The FP64 instruction mix of B5's d = 2 kernel per entry (its unrolled
    body writes 8 entries), from cuobjdump where the toolkit has it: the
    basis of EXP_FLOPS."""
    sass = _sass("sqexp_entries")
    if sass is None:
        print("[build] cuobjdump not found; FP64 instruction mix not read")
        return
    body = sass.split("sqexp_entries_kernelIdLi2EE")[1].split("Function :")[0]
    mix = {op: len(re.findall(rf"\b{op}\b", body)) / 8 for op in ("DFMA", "DADD", "DMUL")}
    print(f"[build] B5 (d = 2) SASS, FP64 instructions per entry: {mix}")


def _random_state(P, K, seed, inv_temp):
    """A mid-adaptation state of K chains on a P-dim Gaussian form, so one
    transition exercises the adaptation's grow and adjust branches."""
    rng = np.random.default_rng(seed)
    if P == N_DIM:
        cov = make_cov()
    else:
        B = rng.normal(size=(P, P)) / np.sqrt(P)
        cov = B @ B.T + np.eye(P)
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov))).cuda()
    theta = torch.as_tensor(
        rng.multivariate_normal(np.zeros(P), cov, K).T.copy(), dtype=torch.float32
    ).cuda()
    num = rng.integers(0, 20, K)
    cuda = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt).cuda()
    eps = AdaptiveScale(
        value=cuda(rng.uniform(0.1, 0.3, K)),
        avg=cuda(num * rng.uniform(0.4, 0.9, K)),
        var=cuda(num * 0.2),
        num=cuda(num, torch.int32),
        chk_int=cuda(rng.choice([15, 20], K), torch.int32),
    )
    logp = form.value_cols(theta) * inv_temp
    return form, theta, logp.contiguous(), eps, torch.full((K,), inv_temp).cuda()


def _close(a, b):
    return torch.isclose(a, b.to(a.dtype), rtol=RTOL, atol=ATOL)


def _agreement(kernel, plain):
    """Per-chain agreement of two one-transition results: position, logp
    and step size within RTOL/ATOL, adaptation counters equal. Returns
    (share of chains that agree, max abs position error over those)."""
    (t1, lp1, e1, _), (t2, lp2, e2, _) = kernel, plain
    ok = _close(t1, t2).all(dim=0) & _close(lp1, lp2) & _close(e1.value, e2.value)
    ok &= (e1.num == e2.num) & (e1.chk_int == e2.chk_int)
    err = (t1 - t2).abs().amax(dim=0)
    share = float(ok.float().mean())
    max_err = float(err[ok].max()) if bool(ok.any()) else float("inf")
    return share, max_err


def _history_drift(h1, h2):
    """Share of chains whose stored positions still agree after 1, 8, 16,
    32 and all transitions of a chunk."""
    n = h1[0].shape[0]
    return {
        c: float(_close(h1[0][c - 1], h2[0][c - 1]).all(dim=0).float().mean())
        for c in sorted({1, 8, 16, 32, n})
        if c <= n
    }


def _compare(label, P, K, chunk, store, inv_temp, inv_mass, seed):
    """Kernel B1 against its plain version on the same state and draws.

    With one transition, every chain must agree (>= MIN_AGREE of them).
    Over a stored chunk, float32 roundoff makes single chains drift apart
    (a step size one ulp off moves a 50-step trajectory by ~n*omega*ulp,
    and the drift adds up over transitions), so the chunk is held to: the
    first transition and every transition's step count agree per chain,
    the accept fraction of every transition agrees to 1e-3, and the
    kernel drifts from the plain version no further than the plain
    version in float32 drifts from itself in float64."""
    form, theta, logp, eps, it = _random_state(P, K, seed, inv_temp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    z = torch.randn((chunk, P, K), generator=gen, device="cuda")
    us = torch.rand((chunk, K), generator=gen, device="cuda")
    ua = torch.rand((chunk, K), generator=gen, device="cuda")
    im = None if inv_mass is None else torch.as_tensor(inv_mass, dtype=torch.float32).cuda()
    kw = dict(form=form, steps=HMC_STEPS, inv_mass_diag=im, store=store)
    args = (theta, logp, eps, it, z, us, ua)
    kernel = hmc_fused._launch_chunk(*args, **kw)
    plain = hmc_fused._reference_chunk(*args, **kw)
    torch.cuda.synchronize()
    where = f"[check {label}] P={P} K={K} chunk={chunk}"
    if not store:
        share, max_err = _agreement(kernel, plain)
        print(f"{where}: {share:.6f} of chains agree (disagree: {1 - share:.6f}), "
              f"max abs err on those {max_err:.3e}")
        if share < MIN_AGREE:
            raise RuntimeError(f"check {label}: only {share:.6f} of chains agree")
        return max_err

    hk, hp = kernel[3], plain[3]
    first = (_close(hk[0][0], hp[0][0]).all(dim=0) & _close(hk[1][0], hp[1][0])
             & _close(hk[3][0], hp[3][0]) & (hk[2] == hp[2]).all(dim=0))
    share = float(first.float().mean())
    print(f"{where}: {share:.6f} of chains agree on the first transition and on "
          f"every transition's step count (disagree: {1 - share:.6f})")
    if share < MIN_AGREE:
        raise RuntimeError(f"check {label}: only {share:.6f} of chains agree")

    accepted = lambda h, t0: (h[0] != torch.cat([t0[None], h[0][:-1]])).any(dim=1)
    fk = accepted(hk, theta).float().mean(dim=1)
    fp = accepted(hp, theta).float().mean(dim=1)
    worst = float((fk - fp).abs().max())
    print(f"{where}: accept fraction per transition: kernel mean "
          f"{float(fk.mean()):.4f}, plain mean {float(fp.mean()):.4f}, "
          f"max difference {worst:.2e}")
    if worst > 1e-3:
        raise RuntimeError(f"check {label}: accept fractions differ by {worst}")

    f64 = lambda x: x.double() if x.is_floating_point() else x
    form64 = GaussianForm(form.A.double()).double().cuda()
    wide = hmc_fused._reference_chunk(
        *(f64(x) for x in (theta, logp)), AdaptiveScale(*map(f64, eps)),
        *(f64(x) for x in (it, z, us, ua)),
        form=form64, steps=HMC_STEPS, inv_mass_diag=im, store=True,
    )
    drift_kp = _history_drift(hk, hp)
    drift_pw = _history_drift(hp, wide[3])
    print(f"{where}: share of chains still within tolerance after n transitions, "
          f"kernel vs plain {drift_kp}; plain float32 vs plain float64 {drift_pw}")
    if drift_kp[chunk] < drift_pw[chunk] - 0.01:
        raise RuntimeError(
            f"check {label}: the kernel drifts further from the plain version "
            f"({drift_kp[chunk]:.4f} agree) than float32 roundoff explains "
            f"({drift_pw[chunk]:.4f})"
        )


def _time_chunk():
    """CUDA-event times of one 64-transition chunk of the main path's shape,
    kernel and plain version on the same inputs, without history."""
    form, theta, logp, eps, it = _random_state(N_DIM, N_CHAINS, 7, 1.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    z = torch.randn((64, N_DIM, N_CHAINS), generator=gen, device="cuda")
    us = torch.rand((64, N_CHAINS), generator=gen, device="cuda")
    ua = torch.rand((64, N_CHAINS), generator=gen, device="cuda")
    kw = dict(form=form, steps=HMC_STEPS, inv_mass_diag=None, store=False)
    args = (theta, logp, eps, it, z, us, ua)

    def timed(fn, reps):
        fn(*args, **kw)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    plain_ms = timed(hmc_fused._reference_chunk, 2)
    ms = timed(hmc_fused._launch_chunk, 10)
    plain_ms_2 = timed(hmc_fused._reference_chunk, 2)
    ms_2 = timed(hmc_fused._launch_chunk, 10)
    bound_ms, bound_by = _b1_bound(us)
    print(f"[time] one chunk (64 transitions, K={N_CHAINS}, P={N_DIM}): kernel "
          f"{ms:.3f} / {ms_2:.3f} ms, plain version {plain_ms:.3f} / "
          f"{plain_ms_2:.3f} ms (plain, kernel, plain, kernel); bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return min(ms, ms_2), min(plain_ms, plain_ms_2), bound_ms, bound_by


def _b1_bound(us, P=N_DIM, steps=HMC_STEPS):
    """Kernel B1's bound for one chunk with these step-count draws. Per
    transition: the jittered step count n (the kernel's own rule); each
    leapfrog step a drift (3P), a centring (P) and a kick of 2P^2 + 4P
    flops; the first half kick 2P^2 + 5P, the momentum draw 4P, the final
    kinetic energy 3P and some 30 flops of energies and adaptation. Bytes:
    the normals and uniforms read once, the state read and written once."""
    chunk, K = us.shape
    n = (steps * (1.0 + (us.double() - 0.5) * 0.2)).to(torch.int64)
    n = n.clamp(min=1, max=max(int(steps * 1.1), 1))
    flops = float(n.sum()) * (2 * P * P + 8 * P) + chunk * K * (2 * P * P + 12 * P + 30)
    n_bytes = 4 * chunk * K * (P + 2) + 2 * 4 * K * (P + 7)
    return bound(n_bytes, flops, FP32_FLOPS)


def phase_main_path():
    cov = make_cov()
    form = GaussianForm(torch.as_tensor(np.linalg.inv(cov)))
    starts = np.random.default_rng(0).normal(0, 0.1, size=(N_CHAINS, N_DIM))
    hmc_fused.KERNEL_LAUNCHES = 0
    ca = ChainArray(
        "hmc", form, starts, steps=HMC_STEPS, epsilon=0.25, retry=False,
        fused=True, device="cuda", seed=1,
    )
    ca.advance(64, store=False)
    t0 = time.perf_counter()
    ca.advance(640, store=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ca.advance(32, store=True)
    # R-hat of 32 consecutive transitions is biased upward by their
    # autocorrelation, so the mixing checks read a thinned window
    ca.advance(320, store=True, thin=10)
    launches = hmc_fused.KERNEL_LAUNCHES

    theta = ca._history[0]
    accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
    attempts = N_CHAINS * 640 / seconds
    var = ca.get_sample().var(axis=0)
    rel = np.abs(var / np.diag(cov) - 1.0)
    rhat = ca.rhat(burn=32)
    print(f"[main path] fused=True, K={N_CHAINS}: advance(640) in {seconds:.4f} s, "
          f"{attempts:,.0f} attempts/s, acceptance {accept:.4f}, "
          f"{attempts * accept:,.0f} accepted samples/s")
    print(f"[main path] kernel launches {launches}, sample variance within "
          f"{rel.max():.4f} of the target's (relative), max rhat {rhat.max():.5f}")
    if launches == 0:
        raise RuntimeError("the main path launched kernel B1 no time")
    if not np.isfinite(theta).all() or theta.shape != (32, N_CHAINS, N_DIM):
        raise RuntimeError(f"bad history: shape {theta.shape}")
    if rel.max() > 0.10:
        raise RuntimeError(f"sample variance off by {rel.max():.3f} (limit 0.10)")
    if not rhat.max() < 1.05:
        raise RuntimeError(f"max rhat {rhat.max()} (limit 1.05)")
    return launches, attempts, accept


def phase_plain_path():
    form = GaussianForm(torch.as_tensor(np.linalg.inv(make_cov())))
    starts = np.random.default_rng(0).normal(0, 0.1, size=(N_CHAINS, N_DIM))
    ca = ChainArray(
        "hmc", form, starts, steps=HMC_STEPS, epsilon=0.25, retry=False,
        fused=False, device="cuda", seed=1,
    )
    ca.advance(4, store=False)
    t0 = time.perf_counter()
    ca.advance(64, store=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    attempts = N_CHAINS * 64 / seconds
    print(f"[plain path] fused=False, K={N_CHAINS}: advance(64) in {seconds:.4f} s, "
          f"{attempts:,.0f} attempts/s")
    if not np.isfinite(ca.theta).all():
        raise RuntimeError("plain path produced non-finite positions")
    return attempts


# ---------------------------------------------------------------------------
# kernel B2 and the dense GP path (gp-16k)
# ---------------------------------------------------------------------------

GP_N = 16_384
GP_THETA = np.array([0.0, 0.0, 0.5, 0.5])  # gp_lml_bench.py: ConstantMean, SquaredExponential
GP_REPS = 3
# kernel B2 vs its plain version: the same operations in the same order
# (--fmad=false); only the exp may differ, by a few ulp
B2_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
F64, CUDA = torch.float64, "cuda"


def make_gp_data(n, d=2, seed=0):
    """``benchmarks/gp_lml_bench.py::make_data``: x uniform on [0, 10]^d,
    y = sin x0 cos x1 + N(0, 0.1) noise, y_err = 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def _gp_operands(x, dtype, theta=GP_THETA):
    """Rows, amplitude and lengthscales of the squared exponential at
    ``theta`` on the card."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=CUDA)
    return t(x), t(np.exp(theta[1])), t(np.exp(theta[2:]))


def _errors(kernel, plain):
    err = (kernel - plain).abs()
    return float(err.max()), float((err / plain.abs()).max())


def _b2_compare(label, u, v, amp, ls):
    """Kernel B2 against its plain version on the same inputs."""
    k = pairwise._launch_sqexp(u, v, amp, ls)
    p = pairwise._sqexp_reference(u, v, amp, ls)
    torch.cuda.synchronize()
    if k.shape != p.shape or not bool(torch.isfinite(k).all()):
        raise RuntimeError(f"check {label}: bad output, shape {tuple(k.shape)}")
    max_abs, max_rel = _errors(k, p)
    rtol = B2_RTOL[u.dtype]
    print(f"[check {label}] B2 {str(u.dtype)[6:]} {u.shape[0]}x{v.shape[0]} D={u.shape[1]}: "
          f"max abs err {max_abs:.3e}, max rel err {max_rel:.3e} (limit {rtol:g})")
    if not max_rel <= rtol:
        raise RuntimeError(f"check {label}: B2 disagrees with its plain version ({max_rel})")
    return max_abs, max_rel


def phase_b2_checks(x16k):
    out = {}
    for label, dtype in (("6a", F64), ("6b", torch.float32)):
        u, amp, ls = _gp_operands(x16k, dtype)
        out[dtype] = _b2_compare(label, u, u, amp, ls)
        del u
        torch.cuda.empty_cache()
    rng = np.random.default_rng(6)
    t = lambda a: torch.as_tensor(a, dtype=F64, device=CUDA)
    ragged = _b2_compare("6c", t(rng.uniform(0, 3, (3001, 5))), t(rng.uniform(0, 3, (2500, 5))),
                         t(1.3), t(rng.uniform(0.5, 2.0, 5)))
    out[F64] = tuple(max(a, b) for a, b in zip(out[F64], ragged))

    # the autograd.Function's backward against autograd of the plain version
    u, amp, ls = _gp_operands(x16k[:4096], F64)
    kbar = torch.as_tensor(np.random.default_rng(7).normal(size=(4096, 4096)), dtype=F64,
                           device=CUDA)
    grads = []
    for fn in (pairwise.SqexpCovariance.apply, pairwise._sqexp_reference):
        leaves = [a.clone().requires_grad_(True) for a in (u, amp, ls)]
        (fn(leaves[0], leaves[0], leaves[1], leaves[2]) * kbar).sum().backward()
        grads.append([a.grad for a in leaves])
    torch.cuda.synchronize()
    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)]
    print(f"[check 6d] B2 backward vs autograd of the plain version, N=4096 float64: "
          f"max rel err (positions, amplitude, lengthscales) "
          f"{', '.join(f'{r:.3e}' for r in rels)} (limit 1e-10)")
    if not max(rels) <= 1e-10:
        raise RuntimeError(f"check 6d: the backward disagrees ({rels})")
    return out


def _cdist_exp(u, v, amplitude, lengthscales):
    """The nearest library yardstick of B2: ``torch.cdist`` of the scaled
    rows, then the square, scale, exp and amplitude as in-place passes (no
    single PyTorch call computes the squared exponential)."""
    us, vs = pairwise._scaled(u, v, lengthscales)
    return torch.cdist(us, vs).square_().mul_(-0.5).exp_().mul_(amplitude**2)


def phase_b2_timing(x16k):
    """CUDA-event times of B2 and its plain version at 16,384 x 16,384, in
    turns (plain, kernel, plain, kernel), beside cdist and the exp. Returns
    per dtype (kernel ms, plain ms, cdist+exp ms, bound ms, bound by)."""
    times = {}
    for dtype in (F64, torch.float32):
        u, amp, ls = _gp_operands(x16k, dtype)
        args = (u, u, amp, ls)
        plain = [time_events(pairwise._sqexp_reference, args, 3)]
        kern = [time_events(pairwise._launch_sqexp, args, 20)]
        plain.append(time_events(pairwise._sqexp_reference, args, 3))
        kern.append(time_events(pairwise._launch_sqexp, args, 20))
        lib = time_events(_cdist_exp, args, 5)
        m, d = u.shape
        size = u.element_size()
        b_ms, b_by = bound(size * (m * m + 2 * m * d), m * m * (3 * d + 2 + EXP_FLOPS),
                           FP64_FLOPS if dtype == F64 else FP32_FLOPS)
        print(f"[time] B2 {str(dtype)[6:]} 16384x16384 D=2: kernel "
              f"{kern[0]:.4f} / {kern[1]:.4f} ms, plain version {plain[0]:.4f} / "
              f"{plain[1]:.4f} ms (plain, kernel, plain, kernel); cdist + exp {lib:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by})")
        times[dtype] = (min(kern), min(plain), lib, b_ms, b_by)
        del u
        torch.cuda.empty_cache()
    return times


def _plain_gp(x, y, err, theta):
    """The independent plain route: B2's plain version, jitter and noise on
    the diagonal, torch.linalg.cholesky; returns (L, residual, amp, ls)."""
    xs, amp, ls = _gp_operands(x, F64, theta)
    K = pairwise._sqexp_reference(xs, xs, amp, ls)
    K.diagonal().add_(amp**2 * 1e-12)
    K.diagonal().add_(torch.as_tensor(err**2, dtype=F64, device=CUDA))
    L = torch.linalg.cholesky(K)
    r = torch.as_tensor(y, dtype=F64, device=CUDA) - float(theta[0])
    return L, r, amp, ls


def _plain_lml(x, y, err, theta):
    L, r, _, _ = _plain_gp(x, y, err, theta)
    v = torch.linalg.solve_triangular(L, r[:, None], upper=False)[:, 0]
    return float(-0.5 * (v @ v) - torch.log(torch.diagonal(L)).sum())


def _time_lml_grad(gp):
    gp.marginal_likelihood_gradient(GP_THETA)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GP_REPS):
        value, grad = gp.marginal_likelihood_gradient(GP_THETA)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / GP_REPS, value, grad


def phase_gp_main(x, y, err):
    """gp-16k: GpRegressor at N=16,384 in float64 on the card."""
    torch.cuda.reset_peak_memory_stats()
    pairwise.KERNEL_LAUNCHES = 0
    gp = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA)
    seconds, lml, grad = _time_lml_grad(gp)
    launches = pairwise.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[gp main] N={GP_N} float64: {1 / seconds:.4f} LML+grad evals/s "
          f"({seconds * 1e3:.2f} ms each, mean of {GP_REPS}), peak device memory "
          f"{peak:.2f} GiB, kernel B2 launches {launches}")
    print(f"[gp main] LML {lml!r}, gradient {grad.tolist()}")
    if launches == 0:
        raise RuntimeError("the GP main path launched kernel B2 no time")
    if not (np.isfinite(lml) and grad.shape == (4,) and np.isfinite(grad).all()):
        raise RuntimeError(f"bad LML or gradient: {lml}, {grad}")

    plain = _plain_lml(x, y, err, GP_THETA)
    rel = abs(lml - plain) / abs(plain)
    print(f"[gp check a] LML against the independent plain route: {plain!r}, "
          f"rel diff {rel:.3e} (limit 1e-10)")
    if not rel <= 1e-10:
        raise RuntimeError(f"LML disagrees with the plain route ({rel})")

    h = 1e-4
    fd = np.empty(4)
    for i in range(4):
        tp, tm = GP_THETA.copy(), GP_THETA.copy()
        tp[i] += h
        tm[i] -= h
        fd[i] = (gp.marginal_likelihood(tp) - gp.marginal_likelihood(tm)) / (2 * h)
    rel_fd = float(np.abs(grad - fd).max() / np.abs(grad).max())
    print(f"[gp check b] gradient against central differences (h={h}): {fd.tolist()}, "
          f"max diff / max |grad| {rel_fd:.3e} (limit 1e-5)")
    if not rel_fd <= 1e-5:
        raise RuntimeError(f"gradient disagrees with finite differences ({rel_fd})")
    _profile_evaluation(gp)
    del gp
    torch.cuda.empty_cache()

    gp_a = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA,
                       cholesky="analytic")
    seconds_a, lml_a, grad_a = _time_lml_grad(gp_a)
    rel_a = float(np.abs(grad_a - grad).max() / np.abs(grad).max())
    print(f"[gp analytic] cholesky='analytic': {1 / seconds_a:.4f} LML+grad evals/s "
          f"({seconds_a * 1e3:.2f} ms each) against {seconds * 1e3:.2f} ms for 'auto'; "
          f"gradient max diff / max |grad| {rel_a:.3e}")
    if not rel_a <= 1e-8:
        raise RuntimeError(f"the analytic gradient disagrees ({rel_a})")
    del gp_a
    torch.cuda.empty_cache()

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the float32 evaluation needs them off")
    gp32 = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=torch.float32, device=CUDA)
    before = pairwise.KERNEL_LAUNCHES
    lml32, grad32 = gp32.marginal_likelihood_gradient(GP_THETA)
    print(f"[gp float32] LML {lml32!r} (float64 {lml!r}, rel diff "
          f"{abs(lml32 - lml) / abs(lml):.3e}), gradient {grad32.tolist()}")
    if pairwise.KERNEL_LAUNCHES == before or not np.isfinite([lml32, *grad32]).all():
        raise RuntimeError("the float32 evaluation did not run through B2 or is not finite")
    del gp32
    torch.cuda.empty_cache()
    return launches, 1 / seconds, 1 / seconds_a


def phase_gp_fit_predict():
    """fit(optimizer="bfgs", n_starts=2) and __call__ at N=4,096, float64."""
    x, y, err = make_gp_data(4096)
    gp = GpRegressor(x, y, y_err=err, hyperpars=GP_THETA, dtype=F64, device=CUDA)
    lwr, upr = (np.array([b[i] for b in gp.hp_bounds]) for i in (0, 1))
    lml_centre = gp.marginal_likelihood(0.5 * (lwr + upr))
    t0 = time.perf_counter()
    theta = gp.fit(optimizer="bfgs", n_starts=2)
    seconds = time.perf_counter() - t0
    lml_fit = gp.marginal_likelihood(theta)
    print(f"[gp fit] N=4096: two L-BFGS-B starts in {seconds:.2f} s, LML {lml_fit!r} at "
          f"{theta.tolist()} (start centre {lml_centre!r})")
    if not lml_fit >= lml_centre:
        raise RuntimeError("the fit ended below the LML at the start centre")

    gp.set_hyperparameters(theta)
    q = np.random.default_rng(8).uniform(0, 10, (4096, 2))
    before = pairwise.KERNEL_LAUNCHES
    mu, sd = gp(q)
    if pairwise.KERNEL_LAUNCHES == before:
        raise RuntimeError("prediction at 4096 points did not launch kernel B2")
    L, r, amp, ls = _plain_gp(x, y, err, theta)
    alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
    K_qx = pairwise._sqexp_reference(_gp_operands(q, F64)[0], _gp_operands(x, F64)[0], amp, ls)
    mu_ref = (K_qx @ alpha + float(theta[0])).cpu().numpy()
    v = torch.linalg.solve_triangular(L, K_qx.T, upper=False)
    sd_ref = torch.sqrt(torch.abs(amp**2 - (v**2).sum(dim=0))).cpu().numpy()
    rel_mu = float(np.abs(mu - mu_ref).max() / np.abs(mu_ref).max())
    rel_sd = float(np.abs(sd - sd_ref).max() / np.abs(sd_ref).max())
    print(f"[gp predict] 4096 points: mean and sd against the plain route, max diff / "
          f"max value {rel_mu:.3e} and {rel_sd:.3e} (limit 1e-10)")
    if not (np.isfinite(mu).all() and np.isfinite(sd).all() and mu.shape == (4096,)):
        raise RuntimeError("bad predictions")
    if not max(rel_mu, rel_sd) <= 1e-10:
        raise RuntimeError(f"predictions disagree with the plain route ({rel_mu}, {rel_sd})")


def _profile_evaluation(gp):
    """torch.profiler over one LML+gradient evaluation: device time of the
    heaviest operations (nested ones included) and the device idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gp.marginal_likelihood_gradient(GP_THETA)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    device = sum(e.self_device_time_total for e in events if e.device_type == cuda) / 1e3
    print(f"[gp profile] one evaluation: {wall:.3f} ms wall, {device:.3f} ms of device "
          f"kernels (device idle {100 * (1 - device / wall):.1f}%)")
    ops = [e for e in events if e.device_type != cuda and e.device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:10]:
        print(f"[gp profile] {e.device_time_total / 1e3:10.3f} ms  {e.count:3d}x  {e.key[:90]}")


# ---------------------------------------------------------------------------
# kernels B3-B8 and the matrix-free small-noise GP (gp-large-50k, -16k)
# ---------------------------------------------------------------------------

LARGE_N = 50_000
LARGE_KW = dict(hyperpars=[0.0, 0.0, 0.0], block_size=4096, preconditioner_rank=512,
                solver="df64", cg_tol=1e-9, cg_maxiter=3000)
DF64_TOL = 1e-13  # B3/B4/B6/B8 vs plain, per entry of sum_j |E_ij| |V_jk|
F32_STORE_TOL = 2.0**-24 + 1e-13  # B8 vs B6: the float32 store's rounding


def make_large_data(n, seed=0):
    """``benchmarks/df64_solve_bench.py``'s data: x uniform on [0, 10]^2,
    y = sin x0 cos x1 + N(0, 0.01^2), y_err = 0.01."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    return x, y, np.full(n, 0.01)


def _padded(x, block=4096):
    """x padded to a multiple of ``block`` with mean rows, as LargeScaleGP
    pads it."""
    extra = -(-len(x) // block) * block - len(x)
    return np.concatenate([x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)])


def _scaled_err(got, ref, scale):
    """(max abs error, max error over sum_j |E_ij| |V_jk|)."""
    err = (got - ref).abs()
    return float(err.max()), float((err / scale).max())


def _bit_for_bit(label, kernel, E, us, round_f32=False):
    """A stored entry matrix against its plain version, row block by row
    block, so the full matrix exists once; raises on any differing bit."""
    n = us.shape[0]
    mismatches, worst = 0, 0.0
    for blk in df64._row_blocks(n, n):
        ref = df64._entry_block(us[blk], us)
        diff = (E[blk] - (ref.float() if round_f32 else ref)).abs()
        mismatches += int((diff != 0).sum())
        worst = max(worst, float(diff.max()))
        del diff, ref
    print(f"[check {label}] {kernel} n={n}: {mismatches} of {n * n} entries differ from the "
          f"plain version, max abs err {worst:.3e} (bit for bit expected)")
    if mismatches:
        raise RuntimeError(f"check {label}: {kernel} differs from its plain version in "
                           f"{mismatches} entries")
    return worst


def phase_df64_checks(xpad):
    """Kernels B3-B8 against their plain versions at full width on the
    same inputs. Returns the max abs errors by kernel and the operands."""
    n = xpad.shape[0]
    uh, ul = (torch.as_tensor(a, device=CUDA) for a in df64.split_f64(xpad))
    us = uh.double() + ul.double()
    V = torch.as_tensor(np.random.default_rng(9).normal(size=(n, 8)).astype(np.float32),
                        device=CUDA)
    errs = {}
    E = df64.sqexp_entries_df64(uh, ul)
    errs["B5"] = _bit_for_bit("9a", "B5", E, us)
    E32 = df64.sqexp_entries_f32(uh, ul)
    errs["B7"] = _bit_for_bit("9f", "B7", E32, us, round_f32=True)

    def held(label, kernel, got, ref, scale, tol=DF64_TOL):
        max_abs, rel = _scaled_err(got, ref, scale)
        if tol == DF64_TOL:
            errs[kernel] = max(errs.get(kernel, 0.0), max_abs)
        print(f"[check {label}] max abs err {max_abs:.3e}, max err / sum|E||V| {rel:.3e} "
              f"(limit {tol:g})")
        if not (rel <= tol and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"check {label}: {kernel} disagrees ({rel})")

    fused = {}
    for q in (1, 2, 8):
        Vq = V[:, :q].contiguous()
        scale = df64._stored_reference(E, Vq.abs())
        got = df64.sqexp_stored_matmat_df64(E, Vq)
        held(f"9b B6 q={q} vs plain", "B6", got, df64._stored_reference(E, Vq), scale)
        if q != 2:
            fused[q] = df64.sqexp_matmat_df64(uh, ul, Vq)
            held(f"9c B4 q={q} vs plain", "B4", fused[q], df64._fused_reference(us, us, Vq),
                 scale)
            held(f"9d B6 vs B4 q={q}", "B6", got, fused[q], scale)
        got32 = df64.sqexp_stored_f32_matmat(E32, Vq)
        held(f"9g B8 q={q} vs plain", "B8", got32, df64._stored_reference(E32, Vq),
             df64._stored_reference(E32, Vq.abs()))
        held(f"9h B8 vs B6 q={q}", "B8", got32, got, scale, F32_STORE_TOL)
    scale1 = df64._stored_reference(E, V[:, :1].abs())[:, 0]
    held("9e B3 vs plain", "B3", df64.sqexp_matvec_df64(uh, ul, V[:, 0].contiguous()),
         df64._fused_reference(us, us, V[:, :1].contiguous())[:, 0], scale1)
    return errs, (uh, ul, us, V)


def _turns(kernel, plain, args, reps_kernel, reps_plain):
    """CUDA-event ms of a kernel and its plain version in turns (plain,
    kernel, plain, kernel); returns the two lists."""
    p = [time_events(plain, args, reps_plain)]
    k = [time_events(kernel, args, reps_kernel)]
    p.append(time_events(plain, args, reps_plain))
    k.append(time_events(kernel, args, reps_kernel))
    return k, p


def phase_df64_timing(operands):
    """B3, B4 (q = 8), B5, B6 (q = 1, 8), B7 and B8 (q = 1, 8) at full width
    with CUDA events, each beside its plain version and its bound; B6 beside
    torch.matmul, B5 beside cdist and the exp, B8 beside a float32
    torch.matmul (the nearest yardstick: no PyTorch call takes float32
    operands to their exact float64 product). Returns {kernel: row of the
    JSON line}."""
    uh, ul, us, V = operands
    n, d = us.shape
    n2 = float(n) * n
    entry = 3 * d + 1 + EXP_FLOPS
    V1, V8 = V[:, :1].contiguous(), V
    rows = {}

    def report(kernel, label, k, p, b, lib=None):
        lib_txt = "" if lib is None else f", library {lib:.4f} ms"
        print(f"[time] {kernel} {label}: kernel {k[0]:.4f} / {k[1]:.4f} ms, plain "
              f"{p[0]:.4f} / {p[1]:.4f} ms{lib_txt}, bound {b[0]:.4f} ms ({b[1]}), "
              f"kernel / bound {min(k) / b[0]:.2f}")
        return {"ms": min(k), "plain_ms": min(p), "bound_ms": b[0], "bound_by": b[1],
                "library_ms": lib}

    k, p = _turns(lambda v: df64.sqexp_matvec_df64(uh, ul, v),
                  lambda v: df64._fused_reference(us, us, v[:, None]), (V1[:, 0],), 10, 1)
    rows["B3"] = report("B3", f"n={n}", k, p, bound(8 * n * d + 12 * n, n2 * (entry + 2),
                                                     FP64_FLOPS))
    k, p = _turns(lambda v: df64.sqexp_matmat_df64(uh, ul, v),
                  lambda v: df64._fused_reference(us, us, v), (V8,), 10, 1)
    rows["B4"] = report("B4", f"n={n} q=8", k, p, bound(8 * n * d + 12 * n * 8,
                                                        n2 * (entry + 16), FP64_FLOPS))
    k, p = _turns(lambda: df64.sqexp_entries_df64(uh, ul), lambda: df64._entries_reference(us),
                  (), 5, 1)
    ones = torch.ones((), dtype=torch.float64, device=CUDA)
    lib = time_events(_cdist_exp, (us, us, ones, torch.ones(d, dtype=torch.float64,
                                                                device=CUDA)), 2)
    row = report("B5", f"n={n} (cdist + exp {lib:.4f} ms)", k, p,
                 bound(8 * n2 + 8 * n * d, n2 * entry, FP64_FLOPS))
    rows["B5"] = {**row, "cdist_exp_ms": lib}
    torch.cuda.empty_cache()
    E = df64.sqexp_entries_df64(uh, ul)
    for q, Vq in ((1, V1), (8, V8)):
        k, p = _turns(lambda v: df64.sqexp_stored_matmat_df64(E, v),
                      lambda v: df64._stored_reference(E, v), (Vq,), 10, 3)
        V64 = Vq.double()
        lib = time_events(torch.matmul, (E, V64), 10)
        rows[f"B6 q={q}"] = report("B6", f"n={n} q={q}", k, p,
                                   bound(8 * n2 + 12 * n * q, 2 * q * n2, FP64_FLOPS), lib)
    del E
    torch.cuda.empty_cache()
    k, p = _turns(lambda: df64.sqexp_entries_f32(uh, ul),
                  lambda: df64._entries_f32_reference(us), (), 5, 1)
    rows["B7"] = report("B7", f"n={n}", k, p, bound(4 * n2 + 8 * n * d, n2 * entry, FP64_FLOPS))
    E32 = df64.sqexp_entries_f32(uh, ul)
    for q, Vq in ((1, V1), (8, V8)):
        k, p = _turns(lambda v: df64.sqexp_stored_f32_matmat(E32, v),
                      lambda v: df64._stored_reference(E32, v), (Vq,), 10, 3)
        yard = time_events(torch.matmul, (E32, Vq), 10)
        row = report("B8", f"n={n} q={q} (float32 torch.matmul {yard:.4f} ms)", k, p,
                     bound(4 * n2 + 12 * n * q, 2 * q * n2, FP64_FLOPS))
        rows[f"B8 q={q}"] = {**row, "matmul_f32_ms": yard}
    return rows


def _plain_residual(gp):
    """The FP64 relative residual of gp's training solve by an independent
    plain route: K alpha from B2's plain version (exact differences) in row
    blocks and torch matmuls, never kernels B3-B8."""
    t = lambda a: torch.as_tensor(a, dtype=F64, device=CUDA)
    xs, alpha, mask = t(gp._x_host), t(gp.alpha64), t(gp._mask)
    amp, ls = t(np.exp(gp.hyperpars[0])), t(np.exp(gp.hyperpars[1:]))
    Ka = torch.cat([pairwise._sqexp_reference(xs[blk], xs, amp, ls) @ alpha
                    for blk in df64._row_blocks(xs.shape[0], xs.shape[0])])
    diag = t(gp._sig_host + np.exp(2 * gp.hyperpars[0]) * 1e-12)
    b = t((gp._y_host - gp.mean_value) * gp._mask)
    return float(((b - Ka - diag * alpha) * mask).norm() / b.norm())


def _profile_solve(gp):
    """torch.profiler over one warm training solve: device idle share and
    the top kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gp._solve_alpha()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[large profile] one warm solve: {wall:.3f} ms wall, {device:.3f} ms of device "
          f"kernels (device idle {100 * (1 - device / wall):.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[large profile] {e.self_device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def _free():
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def _large_run(label, x, y, err, q, store, profile):
    """One LargeScaleGP(solver="df64") instance on the card: cold
    constructor + solve, a warm solve, residuals, predictions. Returns the
    instance, the readings and the kernel launches of the run."""
    print(f"[{label}] device memory allocated before the run: {_free():.2f} GiB")
    for k in df64.KERNEL_LAUNCHES:
        df64.KERNEL_LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, store_entries=store, device=CUDA, **LARGE_KW)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    solver = gp._df64_solver._multi
    chunks = solver.chunks_run
    t0 = time.perf_counter()
    gp._solve_alpha()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    warm_chunks = solver.chunks_run - chunks
    res_kernel = gp.residual_norm_f64()
    res_plain = _plain_residual(gp)
    t0 = time.perf_counter()
    mu = gp(q)
    mu16, sd16 = gp(q[:16], with_variance=True)
    torch.cuda.synchronize()
    pred = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(df64.KERNEL_LAUNCHES)
    print(f"[{label}] store_entries={store!r} (tier {gp._tier}): cold constructor + solve "
          f"{cold:.3f} s, warm solve {warm:.3f} s ({warm_chunks} chunks of "
          f"{solver.restart_every} iterations), FP64 relative residual {res_kernel:.3e} by the "
          f"tier's kernel, {res_plain:.3e} by the plain route; 256 means + 16 variances "
          f"{pred:.3f} s; peak device memory {peak:.2f} GiB; kernel launches {launches}")
    if not (res_plain <= 1e-9 and abs(res_kernel - res_plain) <= 1e-10):
        raise RuntimeError(f"{label}: residual {res_plain} (kernel {res_kernel}), limit 1e-9")
    if not (np.isfinite(mu).all() and mu.shape == (len(q),) and np.isfinite(sd16).all()
            and np.abs(mu16 - mu[:16]).max() <= 1e-9):
        raise RuntimeError(f"{label}: bad predictions")
    if profile:
        _profile_solve(gp)
    return gp, {"cold_s": cold, "warm_s": warm, "warm_chunks": warm_chunks,
                "residual": res_plain, "peak_gib": peak, "mu": mu, "sd16": sd16}, launches


def phase_large_main():
    """gp-large-50k: LargeScaleGP(solver="df64") at N=50,000 on the card,
    with the FP64 entry store, the fused kernel and the float32 store. Each
    run counts its kernel launches from 0."""
    x, y, err = make_large_data(LARGE_N)
    q = np.random.default_rng(1).uniform(0, 10, (256, 2))
    runs, launches = {}, {}
    for store, needs in (("auto", ("B5", "B6")), (False, ("B3", "B4")),
                         ("f32", ("B7", "B8", "B3"))):
        gp, runs[store], launches[store] = _large_run("gp-large-50k", x, y, err, q, store,
                                                      profile=store is not False)
        del gp
        if not all(launches[store][k] for k in needs):
            raise RuntimeError(f"store_entries={store!r} skipped a kernel: {launches[store]}")
    _free()
    total = {k: sum(run[k] for run in launches.values()) for k in df64.KERNEL_LAUNCHES}
    print(f"[gp-large-50k] kernel launches, all three runs: {total}")
    auto = runs["auto"]
    for store in (False, "f32"):
        other = runs[store]
        gap = max(np.abs(auto["mu"] - other["mu"]).max(),
                  np.abs(auto["sd16"] - other["sd16"]).max())
        print(f"[gp-large-50k] 'auto' against {store!r}: max difference of means and sds "
              f"{gap:.3e}; warm solve {auto['warm_s']:.3f} s against {other['warm_s']:.3f} s")
        if not gap <= 1e-7:
            raise RuntimeError(f"the tiers 'auto' and {store!r} disagree by {gap}")
    return total, runs


def phase_large_16k():
    """gp-large-16k: LargeScaleGP(solver="df64") at N=16,384 against a
    dense FP64 Cholesky on the card: training solve, means and variances at
    16 points."""
    n = 16_384
    x, y, err = make_large_data(n)
    q = np.random.default_rng(2).uniform(0, 10, (16, 2))
    t0 = time.perf_counter()
    gp = LargeScaleGP(x, y, err, device=CUDA, **LARGE_KW)
    mu, sd = gp(q, with_variance=True)
    seconds = time.perf_counter() - t0
    xs, qs = (torch.as_tensor(a, dtype=F64, device=CUDA) for a in (x, q))
    one, ls = torch.ones((), dtype=F64, device=CUDA), torch.ones(2, dtype=F64, device=CUDA)
    K = pairwise._sqexp_reference(xs, xs, one, ls)
    K.diagonal().add_(torch.as_tensor(err**2 + 1e-12, dtype=F64, device=CUDA))
    L = torch.linalg.cholesky(K)
    del K
    r = torch.as_tensor(y - gp.mean_value, dtype=F64, device=CUDA)
    alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
    Kq = pairwise._sqexp_reference(qs, xs, one, ls)
    mu_ref = (Kq @ alpha).cpu().numpy() + gp.mean_value
    v = torch.linalg.solve_triangular(L, Kq.T, upper=False)
    var_ref = (1.0 - (v * v).sum(dim=0)).cpu().numpy()
    d_alpha = float(np.abs(gp.alpha64 - alpha.cpu().numpy()).max() / alpha.abs().max())
    d_mu = float(np.abs(mu - mu_ref).max())
    d_var = float(np.abs(sd**2 - var_ref).max())
    print(f"[gp-large-16k] N={n}: constructor + 16 means and variances {seconds:.3f} s; against "
          f"the dense FP64 Cholesky: alpha max diff / max |alpha| {d_alpha:.3e} (limit "
          f"1e-8), means "
          f"{d_mu:.3e} (limit 1e-6), variances {d_var:.3e} (limit 1e-9; truth "
          f"{var_ref.min():.3e} to {var_ref.max():.3e})")
    if not (d_alpha <= 1e-8 and d_mu <= 1e-6 and d_var <= 1e-9):
        raise RuntimeError(f"gp-large-16k disagrees with the dense truth ({d_alpha}, {d_mu}, "
                           f"{d_var})")
    del gp, L
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# the probes P1-P3: kernel B3's measurement harnesses
# ---------------------------------------------------------------------------

SASS_CLASSES = {"fp64": ("DFMA", "DADD", "DMUL"),
                "int": ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX",
                        "IABS"),
                "compare": ("DSETP", "FSETP"), "move": ("MOV", "UMOV", "CS2R", "S2R"),
                "shared": ("LDS", "STS"), "shuffle": ("SHFL",), "tensor": ("IMMA", "HMMA", "DMMA"),
                "convert": ("I2F", "F2I", "F2F", "I2I"), "branch": ("BRA", "BSSY", "BSYNC")}


def _hot_loop_mix(name, symbol, entries):
    """Instructions per entry of the innermost loop that holds FP64 work in
    one kernel of ``name``'s library, read off its SASS with cuobjdump: the
    loop is the smallest span from a backward branch's target to the branch;
    ``entries`` is the number of entries one thread evaluates per trip.
    Returns {class: count per entry, "all": every instruction} or None
    without cuobjdump."""
    sass = _sass(name)
    if sass is None:
        return None
    body = sass.split(symbol)[1].split("Function :")[0]
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^ ;]*([^;]*);", body)]
    where = {a: k for k, (a, _, _) in enumerate(ins)}
    loops = []
    for k, (a, op, rest) in enumerate(ins):
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < a and int(target.group(1), 16) in where:
            loop = [o for _, o, _ in ins[where[int(target.group(1), 16)]:k + 1]]
            if sum(o in SASS_CLASSES["fp64"] for o in loop) >= 4:
                loops.append(loop)
    if not loops:
        return None
    loop = min(loops, key=len)
    mix = {c: sum(o in names for o in loop) / entries for c, names in SASS_CLASSES.items()}
    mix["other"] = len(loop) / entries - sum(mix.values())
    mix["all"] = len(loop) / entries
    return mix


# (label, library, mangled-name fragment, entries per thread per trip of the
# hot loop): B3 itself, and the P2 and P3 kernels whose loops differ from it
HOT_LOOPS = (("B3", "sqexp_fused", "sqexp_fused_kernelILi2ELi1EE", 2),
             ("P2 d2", "sqexp_ablate", "sqexp_ablate_kernelILi0ELi1ELb0EE", 2),
             ("P2 full", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi1ELb0EE", 2),
             ("P2 fullb", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi1ELb1EE", 4),
             ("P2 fulls4", "sqexp_ablate", "sqexp_ablate_kernelILi4ELi4ELb0EE", 8),
             ("P3", "sqexp_words_mma", "sqexp_words_mma_kernelEPKa", 4))


def _print_hot_loops(n, clock_hz):
    """Print each HOT_LOOPS kernel's instructions per entry and two issue
    bounds for n^2 entries: the SMs issuing one warp instruction per cycle
    on each of the 4 schedulers of 132 SMs at ``clock_hz``, and the FP64
    pipe taking 2 cycles per warp instruction. Bounds from a static count,
    not times: they stay out of the kernels JSON line."""
    for label, lib, symbol, entries in HOT_LOOPS:
        mix = _hot_loop_mix(lib, symbol, entries)
        if mix is None:
            print(f"[sass] {label}: hot loop not read (no cuobjdump or no loop found)")
            continue
        issue_ms = float(n) * n / 32 * mix["all"] / (4 * 132 * clock_hz) * 1e3
        fp64_ms = float(n) * n / 32 * mix["fp64"] * 2 / (4 * 132 * clock_hz) * 1e3
        print(f"[sass] {label} hot loop, instructions per entry: "
              + ", ".join(f"{k} {c:g}" for k, c in mix.items())
              + f"; issue bound {issue_ms:.4f} ms at n={n}, FP64 pipe bound {fp64_ms:.4f} ms")


def _f32_distance_control(us64, v):
    """d2exp32 with the distance formed in float32, as a kernel that lost
    the FP64 distance would form it: the control check 12b's limit must
    reject. Plain torch, row block by row block."""
    u32, out = us64.float(), torch.empty(len(v), dtype=torch.float32, device=v.device)
    for blk in df64._row_blocks(len(v), len(v)):
        dist = sum((u32[blk, k][:, None] - u32[:, k][None, :]) ** 2 for k in range(u32.shape[1]))
        out[blk] = torch.exp(-0.5 * dist) @ v
    return out


D2EXP32_TOL = 1e-6  # P2 d2exp32 vs plain, per entry of sum_j |e_ij| |v_j|
D2EXP32_SHIFT = 1e4  # added to the coordinates by check 12b's distance test


def phase_probe_checks(n):
    """P1-P3 against their plain versions on the card: P1 bit for bit in
    every dtype, mode and chain count at the copies its path launches;
    every P2 variant at n, and d2exp32 again on coordinates shifted by
    D2EXP32_SHIFT, where only an FP64 distance keeps it within its limit;
    P3's class sums on one 16 x 8 tile exactly, then its matvec at n against
    its plain version and against B3. Returns the max abs errors by kernel."""
    mismatches, p1_err = 0, 0.0
    for dtype in vpu_probe.DTYPES:
        x = vpu_probe.make_tile(dtype, CUDA)
        for mode in vpu_probe.MODES:
            for n_chains in vpu_probe.CHAINS:
                k = vpu_probe.issue_probe(x, 128, n_chains, mode)
                p = vpu_probe._probe_reference(x, 128, n_chains, mode)
                both_nan = k.isnan() & p.isnan()
                mismatches += int((~((k == p) | both_nan)).sum())
                diff = (k.double() - p.double()).abs()[~both_nan]
                p1_err = max(p1_err, float(diff.max()) if diff.numel() else 0.0)
    torch.cuda.synchronize()
    print(f"[check 12a] P1 at {vpu_probe.REPS} copies: {mismatches} of {2 * 4 * 4 * 128 * 128} "
          f"values differ from the plain version over 2 dtypes x 4 modes x 4 chain counts, max "
          f"abs err {p1_err:.3e} (bit for bit expected)")
    if mismatches or p1_err != 0.0:
        raise RuntimeError(f"check 12a: P1 differs from its plain version in {mismatches} values "
                           f"(max abs err {p1_err})")

    errs = {"P1": p1_err}
    uh, ul, us, v = df64_ablate.make_inputs(n, CUDA)
    worst = {}
    for fn in ("d2", "d2exp32", "d2exp", "noexp", "full"):
        ref = df64_ablate._ablate_reference(us, v, fn)
        scale = df64_ablate._ablate_reference(us, v.abs(), fn)
        tol = D2EXP32_TOL if fn == "d2exp32" else DF64_TOL
        for variant in df64_ablate.VARIANTS:
            if df64_ablate.function_of(variant) != fn:
                continue
            got = df64_ablate.sqexp_ablate(us, v, variant)
            max_abs, rel = _scaled_err(got, ref, scale)
            worst[variant] = (max_abs, rel)
            if not (rel <= tol and bool(torch.isfinite(got).all())):
                raise RuntimeError(f"check 12b: P2 {variant} disagrees with its plain version "
                                   f"({rel}, limit {tol:g})")
        if fn == "d2exp32":
            # the shift moves the FP64 distances by ~1e-12, so the plain
            # version's result stands; float32 holds a coordinate near 1e4
            # only to 5e-4
            shifted = df64_ablate.sqexp_ablate(us + D2EXP32_SHIFT, v, fn)
            _, shift_rel = _scaled_err(shifted, ref, scale)
            _, control_rel = _scaled_err(_f32_distance_control(us + D2EXP32_SHIFT, v), ref, scale)
            print(f"[check 12b] P2 d2exp32 on coordinates shifted by {D2EXP32_SHIFT:g}: max err / "
                  f"sum|e||v| {shift_rel:.3e}; the float32-distance control {control_rel:.3e} "
                  f"(limit {D2EXP32_TOL:g}: the kernel within, the control beyond)")
            if not (shift_rel <= D2EXP32_TOL < control_rel):
                raise RuntimeError(f"check 12b: d2exp32 shifted {shift_rel}, control "
                                   f"{control_rel}, limit {D2EXP32_TOL:g}")
        del ref, scale
    print(f"[check 12b] P2 n={n}, max err / sum|term||w| (max abs err) by variant, limit "
          f"{DF64_TOL:g} (d2exp32 {D2EXP32_TOL:g}): "
          + ", ".join(f"{k} {r:.2e} ({a:.2e})" for k, (a, r) in worst.items()))
    errs["P2"] = worst["full"][0]

    ops = words.prepare(us.cpu().numpy(), CUDA)
    tile, tile_ref = words._launch_tile(ops), words._tile_reference(ops)
    torch.cuda.synchronize()
    print(f"[check 12c] P3 one 16 x 8 tile of the 7 class sums: "
          f"{int((tile != tile_ref).sum())} of {tile.numel()} differ (exact expected)")
    if not torch.equal(tile, tile_ref):
        raise RuntimeError("check 12c: the MMA fragment layout is wrong")
    got = words.words_matvec(ops, v)
    scale = df64._fused_reference(us, us, v.abs()[:, None])[:, 0]
    b3 = df64.sqexp_matvec_df64(uh, ul, v)
    max_abs, rel = _scaled_err(got, words._words_reference(ops, v), scale)
    b3_abs, b3_rel = _scaled_err(got, b3, scale)
    print(f"[check 12d] P3 n={n}: against its plain version max abs err {max_abs:.3e}, max err / "
          f"sum|E||v| {rel:.3e} (limit {DF64_TOL:g}); against B3 {b3_abs:.3e}, {b3_rel:.3e} "
          f"(limit 1e-11)")
    if not (rel <= DF64_TOL and b3_rel <= 1e-11 and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"check 12d: P3 disagrees ({rel}, against B3 {b3_rel})")
    errs["P3"] = max_abs
    return errs


def phase_probe_paths(n):
    """The probes' own entry points, each with its launch count set to 0
    just before and read just after: P1 (the SM clock under load, then every
    dtype, mode and chain count at 512 copies of the tile), P2 (every variant
    and B3 at n) and P3 (the error against the float64 truth and the time
    beside B3 at n). Then the plain versions timed on the same inputs."""
    vpu_probe.KERNEL_LAUNCHES = 0
    mhz, watts, samples = vpu_probe.sm_clock_under_load()
    p1 = vpu_probe.run(CUDA, clock_hz=mhz * 1e6)
    launches = {"P1": vpu_probe.KERNEL_LAUNCHES}
    print(f"[probe P1] SM clock under the float64 load {mhz:.0f} MHz (median of {samples} "
          f"nvidia-smi samples), power draw up to {watts:.1f} W")
    _print_hot_loops(n, mhz * 1e6)
    for r in p1:
        print(f"[probe P1] {r['dtype']} {r['mode']:9s} chains={r['chains']}: {r['ms']:.4f} ms, "
              f"{r['gflops']:.1f} GFLOP/s, {r['cycles_per_warp_instr']:.3f} SM cycles per warp "
              f"instruction, bound {r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%})")

    df64_ablate.KERNEL_LAUNCHES = 0
    p2 = df64_ablate.run(n, CUDA)
    launches["P2"] = df64_ablate.KERNEL_LAUNCHES
    words.KERNEL_LAUNCHES = 0
    p3 = words.run(n, CUDA)
    launches["P3"] = words.KERNEL_LAUNCHES
    print(f"[probe] launches on the probes' paths: {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a probe's path launched its kernel no time: {launches}")

    uh, ul, us, v = df64_ablate.make_inputs(n, CUDA)
    plain = {fn: time_events(df64_ablate._ablate_reference, (us, v, fn), 1)
             for fn in ("d2", "d2exp32", "d2exp", "noexp", "full")}
    for r in p2:
        fn = "full" if r["variant"] == "B3" else df64_ablate.function_of(r["variant"])
        r["plain_ms"] = plain[fn]
        print(f"[probe P2] {r['variant']:8s}: {r['ms']:.4f} ms ({r['ps_per_entry']:.4f} ps/entry), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.2f}x; "
              f"plain version {r['plain_ms']:.4f} ms")
    ops = words.prepare(us.cpu().numpy(), CUDA)
    p3["plain_ms"] = time_events(words._words_reference, (ops, v), 1)
    print(f"[probe P3] n={n}: {p3['ms']:.4f} ms beside B3's {p3['b3_ms']:.4f} ms "
          f"({p3['ms'] / p3['b3_ms']:.3f}x), bound {p3['bound_ms']:.4f} ms; plain version "
          f"{p3['plain_ms']:.4f} ms; error against the float64 truth {p3['err']:.3e} (B3 "
          f"{p3['b3_err']:.3e}) of max |y|; words built on the host in {p3['build_s']:.3f} s")
    if not p3["err"] <= 1e-11:
        raise RuntimeError(f"P3 is {p3['err']} off the float64 truth")
    x = vpu_probe.make_tile(torch.float64, CUDA)
    p1_plain = time_events(vpu_probe._probe_reference, (x, 128, 8, "vv", vpu_probe.REPS), 1)
    print(f"[probe P1] plain version, float64 vv 8 chains at {vpu_probe.REPS} copies: "
          f"{p1_plain:.4f} ms")
    return {"P1": p1, "P2": p2, "P3": p3, "p1_plain_ms": p1_plain, "launches": launches,
            "clock_mhz": mhz, "power_w": watts}


def _probe_rows(probe, errs):
    """The probes' entries of the kernels JSON line: each headline (P1 float64
    vv with 8 chains, P2 full, P3) with every configuration beside it."""
    src = "inference_tpu_torch/ops/csrc/"
    p1 = next(r for r in probe["P1"] if r["dtype"] == "float64" and r["mode"] == "vv"
              and r["chains"] == 8)
    full = next(r for r in probe["P2"] if r["variant"] == "full")
    p3 = probe["P3"]
    return [{
        "name": "issue_probe_kernel<double, vv, 8 chains>", "route": "cuda",
        "source": src + "issue_probe.cu", "replaces": "benchmarks/vpu_probe.py:37",
        "launches": probe["launches"]["P1"], "max_abs_err": errs["P1"], "ms": p1["ms"],
        "plain_ms": probe["p1_plain_ms"], "bound_ms": p1["bound_ms"], "bound_by": "operations",
        "library_ms": None, "sm_clock_mhz": probe["clock_mhz"], "power_w": probe["power_w"],
        "configs": [{k: r[k] for k in ("dtype", "mode", "chains", "ms", "bound_ms",
                                       "cycles_per_warp_instr")} for r in probe["P1"]],
    }, {
        "name": "sqexp_ablate_kernel<full>", "route": "cuda", "source": src + "sqexp_ablate.cu",
        "replaces": "benchmarks/df64_ablate.py:46", "launches": probe["launches"]["P2"],
        "max_abs_err": errs["P2"], "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"], "library_ms": None,
        "variants": {r["variant"]: {k: r[k] for k in ("ms", "bound_ms", "plain_ms")}
                     for r in probe["P2"]},
    }, {
        "name": "sqexp_words_mma_kernel", "route": "cuda", "source": src + "sqexp_words_mma.cu",
        "replaces": "benchmarks/df64_mxu_d2_experiment.py:72",
        "launches": probe["launches"]["P3"], "max_abs_err": errs["P3"], "ms": p3["ms"],
        "plain_ms": p3["plain_ms"], "bound_ms": p3["bound_ms"], "bound_by": p3["bound_by"],
        "library_ms": None, "b3_ms": p3["b3_ms"], "err_vs_truth": p3["err"],
    }]


def main():
    t_start = time.perf_counter()
    name, smi = phase_device()
    torch.set_default_dtype(torch.float32)
    phase_build()
    max_err = _compare("3a", N_DIM, N_CHAINS, 1, False, 1.0, None, 11)
    _compare("3b", N_DIM, N_CHAINS, 64, True, 1.0, None, 12)
    im = np.random.default_rng(5).uniform(0.5, 2.0, 32)
    _compare("3c", 32, 4096, 1, False, 0.5, im, 13)
    ms, plain_ms, b1_bound, b1_by = _time_chunk()
    launches, attempts, accept = phase_main_path()
    plain_attempts = phase_plain_path()
    print(f"[summary] attempts/s: kernel path {attempts:,.0f}, plain path "
          f"{plain_attempts:,.0f} ({attempts / plain_attempts:.2f}x)")

    x16k, y16k, err16k = make_gp_data(GP_N)
    b2_err = phase_b2_checks(x16k)
    b2_ms = phase_b2_timing(x16k)
    b2_launches, evals, evals_a = phase_gp_main(x16k, y16k, err16k)
    phase_gp_fit_predict()
    print(f"[summary] gp-16k float64 LML+grad evals/s: {evals:.4f} (cholesky='auto'), "
          f"{evals_a:.4f} (cholesky='analytic')")
    print(f"[summary] HMC and dense GP phases done at {time.perf_counter() - t_start:.1f} s")

    print(f"[summary] device memory allocated after those phases: {_free():.2f} GiB")
    xpad = _padded(make_large_data(LARGE_N)[0])
    df64_err, operands = phase_df64_checks(xpad)
    df64_ms = phase_df64_timing(operands)
    del operands
    large_launches, runs = phase_large_main()
    phase_large_16k()
    t_probes = time.perf_counter()
    probe_err = phase_probe_checks(len(xpad))
    probe = phase_probe_paths(len(xpad))
    print(f"[summary] probes P1-P3 in {time.perf_counter() - t_probes:.1f} s")
    print(f"[summary] gp-large-50k warm solve: {runs['auto']['warm_s']:.3f} s with the FP64 "
          f"store (B6), {runs[False]['warm_s']:.3f} s fused (B3), {runs['f32']['warm_s']:.3f} s "
          f"with the float32 store (B8, B3 refreshes); all phases done at "
          f"{time.perf_counter() - t_start:.1f} s")

    df64_rows = []
    for kernel, fn, src, line in (
        ("B3", "sqexp_fused_kernel (q = 1)", "sqexp_fused.cu", 472),
        ("B4", "sqexp_fused_kernel", "sqexp_fused.cu", 591),
        ("B5", "sqexp_entries_kernel<double>", "sqexp_entries.cu", 828),
        ("B6", "sqexp_stored_kernel<double>", "sqexp_stored.cu", 971),
        ("B7", "sqexp_entries_kernel<float>", "sqexp_entries.cu", 1088),
        ("B8", "sqexp_stored_kernel<float>", "sqexp_stored.cu", 1180),
    ):
        timing = df64_ms[f"{kernel} q=1" if kernel in ("B6", "B8") else kernel]
        row = {"name": fn, "route": "cuda", "source": f"inference_tpu_torch/ops/csrc/{src}",
               "replaces": f"inference_tpu/ops/df64.py:{line}",
               "launches": large_launches[kernel], "max_abs_err": df64_err[kernel], **timing}
        if kernel in ("B6", "B8"):
            row["q8"] = df64_ms[f"{kernel} q=8"]
        df64_rows.append(row)
    print(json.dumps({"kernels": [{
        "name": "hmc_fused_chunk",
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/hmc_fused.cu",
        "replaces": "inference_tpu/ops/hmc_fused.py:347",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b1_bound,
        "bound_by": b1_by,
        "library_ms": None,
    }, {
        "name": "sqexp_tile_kernel",
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/sqexp.cu",
        "replaces": "inference_tpu/ops/pairwise.py:69",
        "launches": b2_launches,
        "max_abs_err": b2_err[F64][0],
        "ms": b2_ms[F64][0],
        "plain_ms": b2_ms[F64][1],
        "bound_ms": b2_ms[F64][3],
        "bound_by": b2_ms[F64][4],
        "library_ms": None,
        "cdist_exp_ms": b2_ms[F64][2],
        "per_dtype": {
            str(dt)[6:]: {"max_abs_err": b2_err[dt][0], "max_rel_err": b2_err[dt][1],
                          "ms": b2_ms[dt][0], "plain_ms": b2_ms[dt][1],
                          "cdist_exp_ms": b2_ms[dt][2], "bound_ms": b2_ms[dt][3]}
            for dt in (F64, torch.float32)
        },
    }, *df64_rows, *_probe_rows(probe, probe_err)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
