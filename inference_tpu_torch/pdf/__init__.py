"""Density estimation: port of ``inference_tpu.pdf``. The 1D estimators
``GaussianKDE`` and ``UnimodalPdf``, the 2D ``KDE2D`` of the matrix plots,
and the sample highest-density intervals ``sample_hdi`` (numpy) and
``sample_hdi_device`` (a tensor, on its device)."""

from .base import DensityEstimator
from .kde import GaussianKDE, KDE2D
from .unimodal import UnimodalPdf
from .hdi import sample_hdi, sample_hdi_device

__all__ = [
    "DensityEstimator",
    "GaussianKDE",
    "KDE2D",
    "UnimodalPdf",
    "sample_hdi",
    "sample_hdi_device",
]
