"""Posterior building blocks: likelihoods, priors and their composition.
Port of ``inference_tpu.models``, with the port's own
``LinearForwardModel``: the forward model whose posteriors the fused HMC
kernel runs (``ops.hmc_model``)."""

from .likelihoods import (
    Likelihood,
    GaussianLikelihood,
    CauchyLikelihood,
    LogisticLikelihood,
    LinearForwardModel,
)
from .priors import (
    BasePrior,
    JointPrior,
    GaussianPrior,
    ExponentialPrior,
    UniformPrior,
    validate_prior_parameters,
)
from .posterior import Posterior

__all__ = [
    "Likelihood",
    "GaussianLikelihood",
    "CauchyLikelihood",
    "LogisticLikelihood",
    "LinearForwardModel",
    "BasePrior",
    "JointPrior",
    "GaussianPrior",
    "ExponentialPrior",
    "UniformPrior",
    "validate_prior_parameters",
    "Posterior",
]
