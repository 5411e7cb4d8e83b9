"""Hand-written GPU kernels and their plain PyTorch versions:
``hmc_fused`` (kernel B1, fused whole-trajectory HMC transitions) and
``pairwise`` (kernel B2, the squared-exponential covariance block); and
the dense linear algebra of the GP path (``linalg``)."""

from .hmc_fused import GaussianForm

__all__ = ["GaussianForm"]
