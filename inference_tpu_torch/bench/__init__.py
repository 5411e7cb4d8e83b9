"""The port's benches, each run with ``python -m``:

- ``headline``: ``bench.py``'s workload (the 10-dim correlated Gaussian,
  1,024-131,072 chains) through kernel B1, one JSON line with
  ``bench.py``'s keys;
- ``dense_hmc``: ``benchmarks/dense_hmc_bench.py``'s two P = 256 workloads
  on the batched transition;
- ``bo_warm``: ``benchmarks/bo_warm_bench.py``'s warm ``GpOptimiser``
  iteration (the deferred device refit), one JSON line.

On the card by default; ``--device cpu`` runs them on the CPU at a small
size (no device number is printed then).
"""

import subprocess

import torch


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, for the
    JSON lines, or ``"cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
