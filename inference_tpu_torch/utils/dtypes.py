"""Floating-point policy helpers.

The samplers run in float32 on the GPU and in float64 on the CPU when the
default dtype is float64 (the test-suite's setting for numerical parity
checks against the JAX package, which runs with x64 enabled). This is the
counterpart of ``inference_tpu.utils.dtypes``: the switch is torch's own
default dtype, which this package reads and never sets.
"""

import torch


def default_float():
    """The default floating dtype: float64 iff torch's default dtype is
    float64, float32 otherwise."""
    if torch.get_default_dtype() == torch.float64:
        return torch.float64
    return torch.float32
