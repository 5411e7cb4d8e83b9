"""PyTorch and CUDA port of ``inference_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``inference_tpu`` stays the reference. This package ports
its batched-HMC path (``parallel.ChainArray`` for the "hmc" kind, with the
fused whole-trajectory kernel ``ops.hmc_fused`` written in CUDA C++) and
its dense Gaussian-process path (``gp.GpRegressor``, ``gp.GpLinearInverter``,
with the squared-exponential covariance kernel ``ops.pairwise`` in CUDA
C++). It imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"
