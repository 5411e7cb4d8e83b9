"""Drive the PyTorch port's batched-HMC main path once on one CUDA GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. device: a CUDA device is required; prints its name, the device count
   and ``nvidia-smi``'s name and power limit;
2. build: compiles kernel B1 (``inference_tpu_torch/ops/csrc/hmc_fused.cu``)
   with nvcc, times the build and prints the ``-Xptxas -v`` report;
3. kernel against plain version, on the card, in float32, on the same
   random draws: (a) P=10, K=65,536, one transition; (b) the same with
   64 transitions and the history; (c) P=32, diagonal mass, inv_temp 0.5,
   K=4,096. Then both are timed on one chunk of the main path's shape;
4. main path: ``ChainArray("hmc", GaussianForm, ..., fused=True)`` on the
   10-dim correlated Gaussian of ``bench.py`` at 65,536 chains: warm-up,
   a timed advance, a stored advance for the acceptance and a thinned one
   for the mixing checks; checks the launch count, the sample variances
   and R-hat;
5. plain path: the same ChainArray with ``fused=False``, timed.

The second-to-last lines are a JSON object describing the kernel and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from inference_tpu_torch.mcmc._kernels.common import AdaptiveScale
from inference_tpu_torch.ops import _build, hmc_fused
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray

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


def phase_build():
    cached = _build.library_path("hmc_fused").exists()
    t0 = time.perf_counter()
    _build.load("hmc_fused")
    seconds = time.perf_counter() - t0
    print(f"[build] kernel B1 {'loaded from cache' if cached else 'built'} "
          f"in {seconds:.2f} s: {_build.library_path('hmc_fused').name}")
    for line in _build.build_log("hmc_fused").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[build] {line.strip()}")
    return seconds


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
    print(f"[time] one chunk (64 transitions, K={N_CHAINS}, P={N_DIM}): kernel "
          f"{ms:.3f} / {ms_2:.3f} ms, plain version {plain_ms:.3f} / "
          f"{plain_ms_2:.3f} ms (plain, kernel, plain, kernel)")
    return min(ms, ms_2), min(plain_ms, plain_ms_2)


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


def main():
    name, smi = phase_device()
    torch.set_default_dtype(torch.float32)
    phase_build()
    max_err = _compare("3a", N_DIM, N_CHAINS, 1, False, 1.0, None, 11)
    _compare("3b", N_DIM, N_CHAINS, 64, True, 1.0, None, 12)
    im = np.random.default_rng(5).uniform(0.5, 2.0, 32)
    _compare("3c", 32, 4096, 1, False, 0.5, im, 13)
    ms, plain_ms = _time_chunk()
    launches, attempts, accept = phase_main_path()
    plain_attempts = phase_plain_path()
    print(f"[summary] attempts/s: kernel path {attempts:,.0f}, plain path "
          f"{plain_attempts:,.0f} ({attempts / plain_attempts:.2f}x)")
    print(json.dumps({"kernels": [{
        "name": "hmc_fused_chunk",
        "route": "cuda",
        "source": "inference_tpu_torch/ops/csrc/hmc_fused.cu",
        "replaces": "inference_tpu/ops/hmc_fused.py:347",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
