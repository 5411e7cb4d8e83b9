"""The port's batched NUTS bench: ``benchmarks/nuts_bench.py``'s
configuration, unchanged.

The 10-dim Gaussian with ``icov = inv(A A^T + I)``, ``A = N(0, 1) / sqrt(10)``
from ``default_rng(42)``, in torch's default dtype (float32 unless set);
starts ``N(0, 0.1)`` from the same generator, tier by tier. Per chain count,
``steps = max(32, 2^21 // chains)``: ``ChainArray("nuts", epsilon=0.25,
max_depth=8)`` and beside it ``ChainArray("hmc", steps=50, epsilon=0.25,
retry=False)``, each advanced ``warm`` steps (default ``steps``), then
``steps`` timed with ``store=False``, ended by a sync; then ``stored``
transitions (default 64) of the kind's raw transition, stored on the
device and timed, for the trajectory statistics and the ESS.

NUTS transitions cost a variable number of leapfrog steps, and a batch runs
until its slowest lane is done, so its leapfrog gradients are counted two
ways: the lanes' own leaves (the sum of their leapfrog counts) and the
batch's leaves with the finished lanes masked (leaves run x chains, from
``mcmc._kernels.nuts.COUNTS``).

    python -m inference_tpu_torch.bench.nuts [chains ...]        # on the card
    python -m inference_tpu_torch.bench.nuts 64 --device cpu --steps 8 --stored 8

Prints one JSON line a chain count: per kind transitions/s, and for the
stored run its seconds, the ESS per second (each chain's worst parameter,
summed over the chains; the estimator returns at most the run's length, so
over a short run it is bounded by the draw rate) and, for nuts, leapfrog
gradients/s both ways, batch leaves a transition in the timed window and
in the stored run, mean leapfrogs a transition, mean depth, the slowest
lane's leapfrogs a step and the divergences; the working dtype and
``"device"``, the card's name and power limit (``nvidia-smi``) or
``"cpu"``.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc._kernels import nuts as nuts_kernel
from ..parallel import ChainArray
from ..utils import default_float, resolve_device
from ..utils.ess import effective_sample_size_batched
from . import device_label

N_DIM = 10
TIERS = (4096, 16384, 65536)
EPSILON = 0.25
MAX_DEPTH = 8
HMC_STEPS = 50
STORED = 64
KINDS = {"hmc": dict(steps=HMC_STEPS, epsilon=EPSILON, retry=False),
         "nuts": dict(epsilon=EPSILON, max_depth=MAX_DEPTH)}


def make_problem():
    """The bench's precision matrix and the generator its starts come from
    (``nuts_bench.py:37-40``)."""
    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    return np.linalg.inv(A @ A.T + np.eye(N_DIM)), rng


def make_logp(icov, device):
    icov = torch.as_tensor(icov, dtype=default_float(), device=device)
    return lambda t: -0.5 * t @ icov @ t


def tier_steps(n_chains):
    return max(32, (1 << 21) // n_chains)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stored_run(ca, n):
    """``n`` transitions of ``ca``'s raw transition from its state, the
    outputs kept on the device; returns the outputs and the host seconds,
    ended by a sync, and advances ``ca``'s state."""
    run = nuts_kernel.run_steps if ca.kind == "nuts" else hmc_kernel.run_steps
    _sync(ca.device)
    leaves = nuts_kernel.COUNTS["leaves"]
    t0 = time.perf_counter()
    with torch.no_grad():
        ca._state, outs = run(ca._step, ca._state, n, True, ca._generator)
    _sync(ca.device)
    return outs, time.perf_counter() - t0, nuts_kernel.COUNTS["leaves"] - leaves


def ess_per_s(theta, seconds):
    """The stored run's ESS per second: each chain's worst parameter's ESS
    (FFT autocorrelation), summed over the chains, over the run's seconds."""
    series = theta.permute(1, 2, 0).double().cpu()  # (K, P, steps)
    return float(effective_sample_size_batched(series).min(dim=1).values.sum()) / seconds


def measure_tier(n_chains, icov, starts, device, steps=None, warm=None, stored=STORED,
                 kinds=tuple(KINDS)):
    """One chain count's JSON object: each of ``kinds`` (default both)
    timed and its stored run read."""
    steps = tier_steps(n_chains) if steps is None else steps
    warm = steps if warm is None else warm
    logp = make_logp(icov, device)
    out = {"bench": "nuts", "chains": n_chains, "steps": steps}
    for kind in kinds:
        ca = ChainArray(kind, logp, starts, seed=1, device=device, **KINDS[kind])
        ca.advance(warm, store=False)
        leaves = nuts_kernel.COUNTS["leaves"]
        t0 = time.perf_counter()
        ca.advance(steps, store=False)  # ends with a sync on the card
        seconds = time.perf_counter() - t0
        leaves = nuts_kernel.COUNTS["leaves"] - leaves
        row = {"transitions_per_s": n_chains * steps / seconds}
        outs, s_sec, s_leaves = stored_run(ca, stored)
        row.update(stored_steps=stored, stored_s=s_sec, ess_per_s=ess_per_s(outs.theta, s_sec))
        if kind == "nuts":
            lf = outs.leapfrog_steps.cpu().numpy()
            row.update(
                batch_leapfrog_grads_per_s=leaves * n_chains / seconds,
                timed_batch_leaves_per_transition=leaves / steps,
                stored_lane_leapfrog_grads_per_s=float(lf.sum()) / s_sec,
                stored_batch_leapfrog_grads_per_s=s_leaves * n_chains / s_sec,
                mean_leapfrogs=float(lf.mean()),
                mean_depth=float(outs.tree_depth.double().mean()),
                slowest_lane_leapfrogs=float(lf.max(axis=1).mean()),
                batch_leaves_per_transition=s_leaves / stored,
                divergences=int(outs.divergent.sum()),
            )
        out[kind] = row
    out["dtype"] = str(default_float()).rsplit(".", 1)[-1]
    out["device"] = device_label(device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("chains", type=int, nargs="*", default=list(TIERS))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=None,
                        help="timed steps a tier (default max(32, 2^21 // chains))")
    parser.add_argument("--stored", type=int, default=STORED)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "nuts bench")
    icov, rng = make_problem()
    for n_chains in args.chains:
        starts = rng.normal(0, 0.1, size=(n_chains, N_DIM))
        print(json.dumps(measure_tier(n_chains, icov, starts, device, args.steps,
                                      stored=args.stored)), flush=True)


if __name__ == "__main__":
    main()
