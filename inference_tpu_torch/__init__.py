"""PyTorch and CUDA port of ``inference_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``inference_tpu`` stays the reference. This package ports
its batched samplers (``parallel.ChainArray`` for the "hmc", "gibbs",
"metropolis" and "pca" kinds, with the fused whole-trajectory HMC kernel
``ops.hmc_fused`` written in CUDA C++), the single-chain
``mcmc.HamiltonianChain`` with reflecting ``Bounds``, ``MetropolisChain``,
``GibbsChain`` and ``PcaChain``, the ``EnsembleSampler`` (and
``ChainArray``'s "ensemble" kind), parallel tempering on one device
(``ParallelTempering``, ``ChainPool``), posteriors written with numpy
(evaluated on the host, ``utils.wrap``), the
posterior building blocks of ``models`` (likelihoods, priors,
``Posterior``), its dense Gaussian-process path (``gp.GpRegressor``, with
its on-device multistart fit ``optimizer="device"``, and
``gp.GpLinearInverter``, with the squared-exponential covariance kernel
``ops.pairwise`` in CUDA C++), Bayesian optimisation (ROADMAP A10:
``gp.GpOptimiser``, its acquisitions and its deferred device iteration, on
the BFGS batched over starts of ``utils.optimize``) and the matrix-free GP
(``gp.LargeScaleGP`` in its cg, mixed and df64 tiers, with ``fit()``, and
``gp.LargeScaleGpLinearInverter``; the FP64 kernels of ``ops.df64`` in CUDA
C++ serve the small-noise df64 tier). Its benches are ``bench.headline``,
``bench.dense_hmc`` and ``bench.bo_warm``.
Its entry points run on the card unless the caller passes
``device="cpu"``. It imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"

from .mcmc import (
    Bounds,
    ChainPool,
    EnsembleSampler,
    GibbsChain,
    HamiltonianChain,
    MetropolisChain,
    ParallelTempering,
    PcaChain,
)
from .models import (
    CauchyLikelihood,
    ExponentialPrior,
    GaussianLikelihood,
    GaussianPrior,
    JointPrior,
    LogisticLikelihood,
    Posterior,
    UniformPrior,
)
from .gp import GpLinearInverter, GpOptimiser, GpRegressor

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "EnsembleSampler",
    "HamiltonianChain",
    "ParallelTempering",
    "ChainPool",
    "Bounds",
    "GaussianLikelihood",
    "CauchyLikelihood",
    "LogisticLikelihood",
    "GaussianPrior",
    "ExponentialPrior",
    "UniformPrior",
    "JointPrior",
    "Posterior",
    "GpRegressor",
    "GpOptimiser",
    "GpLinearInverter",
]
