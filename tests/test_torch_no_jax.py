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
        "inference_tpu_torch.mcmc, inference_tpu_torch.mcmc.hmc, inference_tpu_torch.mcmc.base, "
        "inference_tpu_torch.mcmc.utilities, inference_tpu_torch.utils.bounds, "
        "inference_tpu_torch.utils.progress, inference_tpu_torch.utils.history",
        "inference_tpu_torch.models, inference_tpu_torch.models.likelihoods, "
        "inference_tpu_torch.models.priors, inference_tpu_torch.models.posterior",
        "inference_tpu_torch.bench, inference_tpu_torch.bench.headline, "
        "inference_tpu_torch.bench.dense_hmc",
        "inference_tpu_torch.mcmc.gibbs, inference_tpu_torch.mcmc.pca, "
        "inference_tpu_torch.mcmc._kernels.metropolis, inference_tpu_torch.utils.wrap, "
        "inference_tpu_torch.parallel._kinds, inference_tpu_torch.parallel.chain_array",
        "inference_tpu_torch.gp.large_inversion, inference_tpu_torch.gp.block_kernels",
        "inference_tpu_torch.gp.optimisation, inference_tpu_torch.gp.acquisition, "
        "inference_tpu_torch.utils.optimize, inference_tpu_torch.utils.figures, "
        "inference_tpu_torch.bench.bo_warm",
        "inference_tpu_torch.mcmc.nuts, inference_tpu_torch.mcmc._kernels.nuts, "
        "inference_tpu_torch.bench.nuts",
        "inference_tpu_torch.pdf, inference_tpu_torch.pdf.base, inference_tpu_torch.pdf.kde, "
        "inference_tpu_torch.pdf.hdi, inference_tpu_torch.pdf.unimodal",
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
