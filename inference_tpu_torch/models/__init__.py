"""Posterior building blocks: likelihoods, priors and their composition.
Port of ``inference_tpu.models``."""

from .likelihoods import (
    Likelihood,
    GaussianLikelihood,
    CauchyLikelihood,
    LogisticLikelihood,
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
    "BasePrior",
    "JointPrior",
    "GaussianPrior",
    "ExponentialPrior",
    "UniformPrior",
    "validate_prior_parameters",
    "Posterior",
]
