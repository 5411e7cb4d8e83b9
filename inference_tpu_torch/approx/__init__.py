"""Conditional-distribution approximations: port of
``inference_tpu.approx``."""

from .conditional import (
    conditional_sample,
    get_conditionals,
    conditional_moments,
    piecewise_linear_sample,
)

__all__ = [
    "conditional_sample",
    "get_conditionals",
    "conditional_moments",
    "piecewise_linear_sample",
]
