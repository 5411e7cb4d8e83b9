"""PyTorch and CUDA port of ``inference_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``inference_tpu`` stays the reference. This package ports
its batched samplers (``parallel.ChainArray`` for every kind: "hmc", with
the fused whole-trajectory HMC kernel ``ops.hmc_fused`` written in CUDA
C++, which also runs the library's posteriors over a linear forward
model (``ops.hmc_model``), "nuts", "gibbs", "metropolis", "pca" and "ensemble"), the single-chain
``mcmc.HamiltonianChain`` with reflecting ``Bounds``, ``NutsChain``,
``MetropolisChain``, ``GibbsChain`` and ``PcaChain``, the
``EnsembleSampler``, parallel tempering on one device
(``ParallelTempering``, ``ChainPool``, NUTS ladders included), the 1D
density estimators of ``pdf`` (``GaussianKDE``, ``UnimodalPdf``,
``sample_hdi``) behind a chain's ``get_marginal`` and ``get_interval``,
posteriors written with numpy
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
C++ serve the small-noise df64 tier; with ``mesh=`` its products split
over the cells of a mesh, across processes too). The multi-device layer is
``parallel`` (meshes, ``ShardedTempering``, the multi-process runtime);
``approx`` holds the conditional approximations (``get_conditionals``,
batched over the variables), ``plotting`` the matrix, trace, HDI and
transition-matrix plots behind the chains' plot views (matplotlib is
imported only to draw), and ``utils.profiling`` ``PhaseTimer`` and
``device_trace`` (``torch.profiler``). Its benches are ``bench.headline``,
``bench.dense_hmc``, ``bench.bo_warm`` and ``bench.nuts``.
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
    NutsChain,
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
from .pdf import GaussianKDE, UnimodalPdf, sample_hdi

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "EnsembleSampler",
    "HamiltonianChain",
    "NutsChain",
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
    "GaussianKDE",
    "UnimodalPdf",
    "sample_hdi",
]
