"""The PyTorch port and its GPU smoke script never import jax (nor
matplotlib, which the card's machine lacks): checked in a fresh
interpreter, so this test process's own imports cannot hide one."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "modules",
    [
        "inference_tpu_torch, inference_tpu_torch.parallel, inference_tpu_torch.ops.hmc_fused",
        "inference_tpu_torch.convert, inference_tpu_torch.utils, inference_tpu_torch.ops._build",
        "inference_tpu_torch.gp, inference_tpu_torch.ops.pairwise, inference_tpu_torch.ops.linalg",
        "inference_tpu_torch.gp.large_scale, inference_tpu_torch.ops.df64, "
        "inference_tpu_torch.ops.solvers",
        "inference_tpu_torch.probes, inference_tpu_torch.probes.vpu_probe, "
        "inference_tpu_torch.probes.df64_ablate, inference_tpu_torch.probes.df64_mxu_d2_experiment",
        "chip_smoke",
    ],
)
def test_port_imports_no_jax(modules):
    code = (
        f"import sys; import {modules}; "
        "leaked = sorted(m for m in sys.modules if m in ('jax', 'inference_tpu', 'matplotlib') or m.startswith(('jax.', 'jaxlib', 'inference_tpu.', 'matplotlib.'))); "
        "print(leaked); sys.exit(1 if leaked else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
