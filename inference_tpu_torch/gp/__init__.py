"""Gaussian processes: dense regression (``GpRegressor``), Bayesian
optimisation (``GpOptimiser`` with the acquisitions
``ExpectedImprovement``, ``UpperConfidenceBound`` and ``MaxVariance``),
linear inversion (``GpLinearInverter``), the matrix-free GP in its three
solver tiers (``LargeScaleGP``) and matrix-free linear inversion
(``LargeScaleGpLinearInverter``), with their covariance and mean
functions. Port of ``inference_tpu.gp``."""

from .regression import GpRegressor
from .optimisation import GpOptimiser
from .inversion import GpLinearInverter
from .large_scale import LargeScaleGP
from .large_inversion import LargeScaleGpLinearInverter
from .acquisition import ExpectedImprovement, UpperConfidenceBound, MaxVariance
from .mean import ConstantMean, LinearMean, QuadraticMean
from .covariance import (
    SquaredExponential,
    RationalQuadratic,
    WhiteNoise,
    HeteroscedasticNoise,
    ChangePoint,
    CovarianceFunction,
    CompositeCovariance,
)

__all__ = [
    "GpRegressor",
    "GpOptimiser",
    "GpLinearInverter",
    "LargeScaleGP",
    "LargeScaleGpLinearInverter",
    "ExpectedImprovement",
    "UpperConfidenceBound",
    "MaxVariance",
    "ConstantMean",
    "LinearMean",
    "QuadraticMean",
    "SquaredExponential",
    "RationalQuadratic",
    "WhiteNoise",
    "HeteroscedasticNoise",
    "ChangePoint",
    "CovarianceFunction",
    "CompositeCovariance",
]
