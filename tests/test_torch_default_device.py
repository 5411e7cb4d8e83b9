"""The port's entry points run on the card unless the caller asks for the
CPU: without a CUDA device, each raises when ``device`` is not given, and
none moves to the CPU on its own. ``torch.cuda.is_available`` is patched
to False, so the test means the same on a machine with a card."""

import numpy as np
import pytest
import torch

from inference_tpu_torch import convert, models
from inference_tpu_torch.bench import bo_warm, dense_hmc, headline
from inference_tpu_torch.bench import nuts as nuts_bench
from inference_tpu_torch.gp import (GpLinearInverter, GpOptimiser, GpRegressor, LargeScaleGP,
                                    LargeScaleGpLinearInverter)
from inference_tpu_torch.mcmc import EnsembleSampler, HamiltonianChain, NutsChain
from inference_tpu_torch.mcmc.hmc import MatrixMass, ScalarMass, VectorMass, get_particle_mass
from inference_tpu_torch.ops.hmc_fused import GaussianForm
from inference_tpu_torch.parallel import ChainArray
from inference_tpu_torch.pdf import KDE2D, GaussianKDE, UnimodalPdf

_X = np.linspace(0.0, 1.0, 8)[:, None]
_Y = np.sin(_X[:, 0])
_ERR = np.full(8, 0.1)

ENTRY_POINTS = {
    "ChainArray": lambda: ChainArray("hmc", GaussianForm(torch.eye(2)), np.zeros((4, 2))),
    "GpRegressor": lambda: GpRegressor(_X, _Y, y_err=_ERR, hyperpars=[0.0, 0.0, 0.0]),
    "GpLinearInverter": lambda: GpLinearInverter(_Y, _ERR, np.eye(8), _X),
    "gp_regressor_from_state": lambda: convert.gp_regressor_from_state({
        "x": _X, "y": _Y, "y_err": _ERR, "y_cov": None, "hyperpars": np.zeros(3),
        "pad_to": None, "kernel": "SquaredExponential", "mean": "ConstantMean",
    }),
    "LargeScaleGP": lambda: LargeScaleGP(_X, _Y, _ERR, hyperpars=[0.0, 0.0], block_size=128,
                                         solver="df64"),
    "LargeScaleGP cg": lambda: LargeScaleGP(_X, _Y, _ERR, hyperpars=[0.0, 0.0]),
    "LargeScaleGpLinearInverter": lambda: LargeScaleGpLinearInverter(_Y, _ERR, np.eye(8), _X,
                                                                     [0.0, 0.0]),
    "large_inverter_from_state": lambda: convert.large_inverter_from_state({
        "y": _Y, "y_err": _ERR, "model_matrix": np.eye(8), "positions": _X,
        "hyperpars": np.zeros(2), "kernel": "SquaredExponential", "prior_mean": 0.0,
        "block_size": 8, "solver": "cg", "store_entries": "auto", "dtype": "float64",
        "cg_tol": 1e-6, "cg_maxiter": 100, "z64": np.zeros(8),
    }),
    "ChainArray ensemble": lambda: ChainArray(
        "ensemble", GaussianForm(torch.eye(2)), np.random.default_rng(0).normal(size=(2, 6, 2))),
    "EnsembleSampler": lambda: EnsembleSampler(
        GaussianForm(torch.eye(2)), np.random.default_rng(0).normal(size=(6, 2)),
        display_progress=False),
    "EnsembleSampler.from_items": lambda: EnsembleSampler.from_items({
        "alpha": 2.0, "display_progress": False}),
    "HamiltonianChain": lambda: HamiltonianChain(GaussianForm(torch.eye(2)), start=np.zeros(2),
                                                 display_progress=False),
    "HamiltonianChain.from_items": lambda: HamiltonianChain.from_items({}),
    "GaussianLikelihood": lambda: models.GaussianLikelihood([1.0], [1.0], lambda t: t),
    "CauchyLikelihood": lambda: models.CauchyLikelihood([1.0], [1.0], lambda t: t),
    "LogisticLikelihood": lambda: models.LogisticLikelihood([1.0], [1.0], lambda t: t),
    "GaussianPrior": lambda: models.GaussianPrior(0.0, 1.0, 0),
    "ExponentialPrior": lambda: models.ExponentialPrior(1.0, 0),
    "UniformPrior": lambda: models.UniformPrior(0.0, 1.0, 0),
    "mass_from_numpy": lambda: convert.mass_from_numpy(1.0, 2),
    "ScalarMass": lambda: ScalarMass(1.0, 2),
    "VectorMass": lambda: VectorMass(np.ones(2), 2),
    "MatrixMass": lambda: MatrixMass(np.eye(2), 2),
    "get_particle_mass": lambda: get_particle_mass(np.ones(2), 2),
    "hmc_state_from_jax": lambda: convert.hmc_state_from_jax(
        [np.zeros((4, 2)), *[np.zeros(4)] * 4, np.zeros(4, np.int32), np.zeros((4, 2), np.uint32),
         np.zeros(4, bool), np.ones(4), np.full(4, 10, np.int32)]),
    "bench.headline": lambda: headline.sweep(chains=(4,), work=4),
    "bench.dense_hmc": lambda: dense_hmc.main([]),
    "GpOptimiser": lambda: GpOptimiser(_X, _Y, bounds=[(0.0, 1.0)], hyperpars=[0.0, 0.0, 0.0]),
    "gp_optimiser_from_state": lambda: convert.gp_optimiser_from_state({
        "x": _X, "y": _Y, "y_err": None, "bounds": [(0.0, 1.0)], "hyperpars": np.zeros(3),
        "kernel": "SquaredExponential", "mean": "ConstantMean", "cross_val": False,
        "acquisition": "ExpectedImprovement", "kappa": None, "optimizer": "device",
        "acquisition_max_history": [], "convergence_metric_history": [],
        "iteration_history": [],
    }),
    "bench.bo_warm": lambda: bo_warm.main([]),
    "ChainArray nuts": lambda: ChainArray("nuts", GaussianForm(torch.eye(2)), np.zeros((4, 2))),
    "NutsChain": lambda: NutsChain(GaussianForm(torch.eye(2)), start=np.zeros(2),
                                   display_progress=False),
    "NutsChain.from_items": lambda: NutsChain.from_items({}),
    "nuts_state_from_jax": lambda: convert.nuts_state_from_jax(
        [np.zeros((4, 2)), np.zeros(4), np.zeros((4, 2)), *[np.zeros(4)] * 3,
         np.zeros(4, np.int32), np.full(4, 15, np.int32), np.zeros((4, 2), np.uint32),
         np.zeros(4, np.int32), np.ones(4)]),
    "bench.nuts": lambda: nuts_bench.main(["64"]),
    "GaussianKDE": lambda: GaussianKDE(np.arange(5.0)),
    "KDE2D": lambda: KDE2D(np.arange(5.0), np.arange(5.0) ** 2),
    "UnimodalPdf": lambda: UnimodalPdf(np.arange(5.0)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_missing_card_raises_without_explicit_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
