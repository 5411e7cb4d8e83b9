"""Hand-written GPU kernels and their plain PyTorch versions:
``hmc_fused`` (kernel B1, fused whole-trajectory HMC transitions) and
``pairwise`` (kernel B2, the squared-exponential covariance block) and
``df64`` (kernels B3-B8, the matrix-free GP's kernel matrix in FP64); the
dense linear algebra of the GP path (``linalg``) and the df64 tier's
solvers (``solvers``)."""

from .hmc_fused import GaussianForm

__all__ = ["GaussianForm"]
