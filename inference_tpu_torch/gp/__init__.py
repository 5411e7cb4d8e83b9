"""Gaussian processes: dense regression (``GpRegressor``) and linear
inversion (``GpLinearInverter``), with their covariance and mean
functions. Port of the dense part of ``inference_tpu.gp``."""

from .regression import GpRegressor
from .inversion import GpLinearInverter
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
