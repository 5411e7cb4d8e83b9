"""The port's headline bench: ``bench.py``'s workload through kernel B1.

The 10-dimensional correlated Gaussian of ``bench.py`` (``make_cov``) as a
``GaussianForm``, ``ChainArray("hmc", ..., steps=50, epsilon=0.25,
retry=False, fused=True)`` at 1,024 to 131,072 chains (``bench.py:20-25``):
per chain count ``max(32, 2^22 // K)`` transitions as a warm-up, then the
same timed, ended by a sync; the acceptance from 32 stored transitions of
the first count (``bench.py:73-80``). Accepted samples/s = attempts/s x
acceptance. ``mfu_pct`` counts ``bench.py``'s flops per transition against
the H100's float32 rate outside the tensor cores (67 TFLOP/s).
``vs_baseline`` is null: the reference implementation is not installed.

    python -m inference_tpu_torch.bench.headline              # on the card
    python -m inference_tpu_torch.bench.headline --device cpu --chains 64 128 --work 256

Prints one JSON line with ``bench.py``'s keys (``bench.py:224-236``) and
``"device"``: the card's name and power limit (``nvidia-smi``), or
``"cpu"``, where ``mfu_pct`` is null (no device rate was measured).
"""

import argparse
import json
import time

import numpy as np
import torch

from ..ops.hmc_fused import GaussianForm
from ..parallel import ChainArray
from ..probes import FP32_FLOPS
from ..utils import resolve_device
from . import device_label

N_DIM = 10
HMC_STEPS = 50                                     # leapfrog steps per proposal
EPSILON = 0.25
CHAIN_SWEEP = (1024, 4096, 16384, 65536, 131072)   # bench.py's sweep
WORK_PER_TIER = 1 << 22                            # chain-transitions timed per tier
ACCEPT_WINDOW = 32                                 # stored transitions for the acceptance


def make_cov():
    """The covariance of ``bench.py``'s 10-dim correlated Gaussian."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    return A @ A.T + np.eye(N_DIM)


def flops_per_transition():
    """``bench.py``'s model flops per transition: ``HMC_STEPS`` gradient
    matvecs and O(P) integrator work."""
    return HMC_STEPS * (2 * N_DIM * N_DIM + 8 * N_DIM)


def sweep(device="cuda", chains=CHAIN_SWEEP, work=WORK_PER_TIER, seed=1):
    """Attempts/s per chain count (``{K: attempts/s}``) and the acceptance,
    on the fused path."""
    device = resolve_device(device, "headline bench")
    form = GaussianForm(torch.as_tensor(np.linalg.inv(make_cov())))
    rng = np.random.default_rng(0)
    attempts, accept = {}, None
    for n_chains in chains:
        steps = max(32, work // n_chains)
        ca = ChainArray(
            "hmc", form, rng.normal(0, 0.1, size=(n_chains, N_DIM)), steps=HMC_STEPS,
            epsilon=EPSILON, retry=False, fused=True, seed=seed, device=device,
        )
        ca.advance(steps, store=False)  # warm-up with the timed length
        if accept is None:
            ca.advance(ACCEPT_WINDOW, store=True)
            theta = np.concatenate(ca._history, axis=0)
            accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
        t0 = time.perf_counter()
        ca.advance(steps, store=False)  # ends with a sync on the card
        attempts[n_chains] = n_chains * steps / (time.perf_counter() - t0)
    return attempts, accept


def measure(device="cuda", chains=CHAIN_SWEEP, work=WORK_PER_TIER):
    """The bench's JSON object, and the attempts/s per chain count."""
    attempts, accept = sweep(device, chains, work)
    scaling = {str(k): a * accept for k, a in attempts.items()}
    peak = max(scaling.values())
    on_card = torch.device(device).type == "cuda"
    mfu = 100 * peak / accept * flops_per_transition() / FP32_FLOPS if on_card else None
    return {
        "metric": "hmc_samples_per_sec_per_chip",
        "value": peak,
        "unit": "samples/s (batched HMC at saturating chain count, 10-dim correlated Gaussian)",
        "vs_baseline": None,
        "scaling": scaling,
        "acceptance": accept,
        "mfu_pct": mfu,
        "device": device_label(device),
    }, attempts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--chains", type=int, nargs="+", default=list(CHAIN_SWEEP))
    parser.add_argument("--work", type=int, default=WORK_PER_TIER,
                        help="chain-transitions timed per chain count")
    args = parser.parse_args(argv)
    result, _ = measure(args.device, args.chains, args.work)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
