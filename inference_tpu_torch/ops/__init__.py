"""Hand-written GPU kernels and their plain PyTorch versions:
``hmc_fused`` (kernel B1, fused whole-trajectory HMC transitions)."""

from .hmc_fused import GaussianForm

__all__ = ["GaussianForm"]
