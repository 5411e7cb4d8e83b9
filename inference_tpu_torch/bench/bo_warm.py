"""The port's warm Bayesian-optimisation iteration:
``benchmarks/bo_warm_bench.py``'s configuration, unchanged.

The objective ``-|x - 3.14|^2 + sin(3 x_0) cos(2 x_1)`` on [0, 6]^2, six
starting points from ``default_rng(0)``, ``GpOptimiser(...,
optimizer="device")`` with expected improvement: two warm-up iterations
(propose, objective, add), then ``n_iterations`` (default 10) timed on the
host clock. With the device optimizer the refit an ``add_evaluation``
defers runs inside the next ``propose_evaluation``, so each timed iteration
holds one fit, one acquisition multistart and the objective.

    python -m inference_tpu_torch.bench.bo_warm              # on the card
    python -m inference_tpu_torch.bench.bo_warm --device cpu --iterations 2

Prints one JSON line: the median, min and max warm-iteration seconds, the
best objective found, the working dtype and ``"device"``, the card's name
and power limit (``nvidia-smi``) or ``"cpu"``.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..gp import GpOptimiser
from ..utils import resolve_device
from . import device_label

BOUNDS = [(0.0, 6.0), (0.0, 6.0)]
N_START = 6
WARMUP = 2
ITERATIONS = 10


def objective(x):
    x = np.atleast_2d(x)
    value = -np.sum((x - 3.14) ** 2, axis=1) + np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])
    return float(value[0])


def make_optimiser(device="cuda", dtype=None):
    """The bench's ``GpOptimiser`` on its six starting points."""
    x0 = np.random.default_rng(0).uniform(0, 6, size=(N_START, 2))
    y0 = np.array([objective(p) for p in x0])
    return GpOptimiser(x0, y0, bounds=BOUNDS, optimizer="device", dtype=dtype,
                       device=resolve_device(device, "bo_warm bench"))


def iterate(opt):
    """One warm iteration: propose, evaluate, add; returns its host seconds
    (ended by the proposal's own read of its results)."""
    t0 = time.perf_counter()
    xq = opt.propose_evaluation()
    opt.add_evaluation(xq, objective(xq))
    return time.perf_counter() - t0


def measure(device="cuda", iterations=ITERATIONS, dtype=None):
    """The bench's JSON object and the optimiser it drove."""
    opt = make_optimiser(device, dtype)
    for _ in range(WARMUP):
        iterate(opt)
    times = np.array([iterate(opt) for _ in range(iterations)])
    return {
        "bench": "bo_warm",
        "warm_iteration_s": {"median": float(np.median(times)), "min": float(times.min()),
                             "max": float(times.max())},
        "iterations": iterations,
        "best_objective": float(opt.y.max()),
        "dtype": str(opt.gp._dtype).rsplit(".", 1)[-1],
        "device": device_label(device),
    }, opt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=ITERATIONS)
    parser.add_argument("--dtype", default=None, choices=(None, "float32", "float64"))
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    print(json.dumps(measure(args.device, args.iterations, dtype)[0]), flush=True)


if __name__ == "__main__":
    main()
