"""Gaussian processes: dense regression (``GpRegressor``), linear
inversion (``GpLinearInverter``), the matrix-free GP in its three solver
tiers (``LargeScaleGP``) and matrix-free linear inversion
(``LargeScaleGpLinearInverter``), with their covariance and mean
functions. Port of that part of ``inference_tpu.gp``."""

from .regression import GpRegressor
from .inversion import GpLinearInverter
from .large_scale import LargeScaleGP
from .large_inversion import LargeScaleGpLinearInverter
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
    "LargeScaleGpLinearInverter",
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
