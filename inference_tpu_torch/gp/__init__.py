"""Gaussian processes: dense regression (``GpRegressor``), linear
inversion (``GpLinearInverter``) and the matrix-free small-noise tier
(``LargeScaleGP(solver="df64")``), with their covariance and mean
functions. Port of that part of ``inference_tpu.gp``."""

from .regression import GpRegressor
from .inversion import GpLinearInverter
from .large_scale import LargeScaleGP
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
    "GpLinearInverter",
    "LargeScaleGP",
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
