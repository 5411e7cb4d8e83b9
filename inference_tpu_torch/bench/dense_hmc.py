"""Dense HMC bench: ``benchmarks/dense_hmc_bench.py``'s two workloads at full
width on the port's batched transition (``ChainArray``, plain path).

1. ``gaussian``: a P = 256 correlated Gaussian (``GaussianForm``) with the
   full-matrix inverse mass matched to its covariance: each leapfrog step
   is a gradient and a mass-velocity product of (chains, P) x (P, P).
2. ``forward-model``: a ``GaussianLikelihood`` over a linear forward model
   y = A theta (a ``LinearForwardModel``) with N_DATA = 1,024 and P = 256,
   unit mass: each gradient is a pair of (chains, P) x (P, N_DATA)
   products.

Both with ``HMC_STEPS = 20``, ``epsilon = 0.1``, ``seed = 1`` and the
chain sweep 256-8,192; per chain count ``max(8, 2^21 // K)`` transitions
as a warm-up, then the same timed, then 16 stored for the acceptance.
Samples/s = chains x transitions x acceptance / s; TFLOP/s by the JAX
bench's flop counts (``flops_per_transition``); the share of the H100's
float32 peak outside the tensor cores (67 TFLOP/s). Matrix products run
in full float32: TF32 stays off. The JAX bench fed its TPU bf16 operands,
so its figures are not comparable and none is printed here.

    python -m inference_tpu_torch.bench.dense_hmc            # on the card
    python -m inference_tpu_torch.bench.dense_hmc --device cpu --chains 8 --work 16

Prints a line per workload and chain count, then one JSON line with
``bench.py``'s keys (``value`` the gaussian workload's best samples/s;
``scaling``, ``acceptance`` and ``mfu_pct`` per workload) and ``"device"``.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..models import GaussianLikelihood, LinearForwardModel
from ..ops.hmc_fused import GaussianForm
from ..parallel import ChainArray
from ..probes import FP32_FLOPS
from ..utils import resolve_device
from . import device_label

P = 256
N_DATA = 1024
HMC_STEPS = 20
EPSILON = 0.1
SEED = 1
CHAIN_SWEEP = (256, 1024, 4096, 8192)
WORK = 1 << 21       # chain-transitions timed per chain count
ACCEPT_WINDOW = 16   # stored transitions for the acceptance


def correlated_gaussian():
    """``(posterior, covariance)``: the P-dim correlated Gaussian of the JAX
    bench as a ``GaussianForm`` (its precision rounded to float32, as
    there) and its float64 covariance, the inverse mass."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(P, P)) / np.sqrt(P)
    cov = A @ A.T + 0.1 * np.eye(P)
    icov = np.linalg.inv(cov).astype(np.float32)
    return GaussianForm(torch.as_tensor(icov.astype(float))), cov


def forward_model(device):
    """``(likelihood, A, y, sigma)``: the JAX bench's ``GaussianLikelihood``
    over y = A theta on ``device``, with A rounded to float32 as there and
    returned as float64 numpy for an exact posterior. The forward model is
    ``LinearForwardModel(A)``, which the plain path differentiates like any
    torch function and ``ChainArray(fused=True)`` runs through the fused
    kernel's model route."""
    rng = np.random.default_rng(7)
    A = (rng.normal(size=(N_DATA, P)) / np.sqrt(P)).astype(np.float32).astype(float)
    theta_true = rng.normal(size=P)
    y = A @ theta_true + 0.1 * rng.normal(size=N_DATA)
    sigma = np.full(N_DATA, 0.1)
    likelihood = GaussianLikelihood(y, sigma, forward_model=LinearForwardModel(A, device=device),
                                    device=device)
    return likelihood, A, y, sigma


def flops_per_transition(kind: str) -> float:
    """The JAX bench's model flops per transition per chain
    (``dense_hmc_bench.py:73-80``)."""
    if kind == "gaussian":
        # per leapfrog step the gradient and the mass velocity, 2 P^2 each;
        # two log-probabilities of 2 P^2
        return HMC_STEPS * 4 * P**2 + 2 * 2 * P**2
    # per leapfrog step two 2 N P products; one log-probability
    return HMC_STEPS * 2 * (2 * N_DATA * P) + 2 * (2 * N_DATA * P)


def run_one(kind, posterior, inverse_mass, n_chains, device, work=WORK):
    """One chain count: ``(row, chain_array)``, the row holding the
    transitions, seconds, acceptance, samples/s, TFLOP/s and share of the
    float32 peak (None off the card)."""
    steps = max(8, work // n_chains)
    starts = np.random.default_rng(0).normal(0, 0.1, size=(n_chains, P))
    ca = ChainArray(
        "hmc", posterior, starts, steps=HMC_STEPS, epsilon=EPSILON,
        inverse_mass=inverse_mass, seed=SEED, retry=False, device=device,
    )
    ca.advance(steps, store=False)  # warm-up and step-size adaptation
    t0 = time.perf_counter()
    ca.advance(steps, store=False)  # ends with a sync on the card
    seconds = time.perf_counter() - t0
    ca.advance(ACCEPT_WINDOW, store=True)
    theta = np.concatenate(ca._history, axis=0)
    accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
    rate = n_chains * steps * accept / seconds
    tflops = n_chains * steps / seconds * flops_per_transition(kind) / 1e12  # attempts carry the flops
    on_card = torch.device(device).type == "cuda"
    row = {
        "chains": n_chains, "transitions": steps, "seconds": seconds, "acceptance": accept,
        "samples_per_s": rate, "tflops": tflops if on_card else None,
        "fp32_peak_pct": 100 * tflops * 1e12 / FP32_FLOPS if on_card else None,
    }
    return row, ca


def workloads(device):
    """``{kind: (posterior, inverse_mass)}`` of the two workloads."""
    gaussian, cov = correlated_gaussian()
    likelihood = forward_model(device)[0]
    return {"gaussian": (gaussian, cov.astype(np.float32)),
            "forward-model": (likelihood, None)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--chains", type=int, nargs="+", default=list(CHAIN_SWEEP))
    parser.add_argument("--work", type=int, default=WORK,
                        help="chain-transitions timed per chain count")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "dense_hmc bench")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for kind, (posterior, inverse_mass) in workloads(device).items():
        rows[kind] = []
        for n_chains in args.chains:
            row, _ = run_one(kind, posterior, inverse_mass, n_chains, device, args.work)
            rows[kind].append(row)
            device_rates = ("TFLOP/s and share of the float32 peak not measured"
                            if row["tflops"] is None else
                            f"{row['tflops']:.4f} TFLOP/s, {row['fp32_peak_pct']:.3f}% of "
                            "the float32 peak")
            print(f"[{kind}] chains={n_chains}: {row['samples_per_s']:.1f} samples/s "
                  f"(acceptance {row['acceptance']:.4f}), {device_rates}", flush=True)
    best = lambda kind: max(rows[kind], key=lambda r: r["samples_per_s"])
    print(json.dumps({
        "metric": "dense_hmc_samples_per_sec_per_chip",
        "value": best("gaussian")["samples_per_s"],
        "unit": "samples/s (batched HMC at the best chain count, P = 256 correlated "
                "Gaussian with full-matrix mass)",
        "vs_baseline": None,
        "scaling": {k: {str(r["chains"]): r["samples_per_s"] for r in v} for k, v in rows.items()},
        "acceptance": {k: best(k)["acceptance"] for k in rows},
        "mfu_pct": {k: best(k)["fp32_peak_pct"] for k in rows},
        "tflops": {k: best(k)["tflops"] for k in rows},
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "device": device_label(device),
    }), flush=True)


if __name__ == "__main__":
    main()
