from .device import resolve_device
from .dtypes import default_float
from .random import make_generator
from .wrap import as_device_logp, validate_posterior
from .bounds import Bounds, reflect_to_bounds
from .progress import ChainProgressPrinter
from .ess import effective_sample_size, effective_sample_size_batched
from .diagnostics import split_rhat, rank_normalized_rhat
from .profiling import device_trace, PhaseTimer

__all__ = [
    "resolve_device",
    "default_float",
    "make_generator",
    "as_device_logp",
    "validate_posterior",
    "Bounds",
    "reflect_to_bounds",
    "ChainProgressPrinter",
    "effective_sample_size",
    "effective_sample_size_batched",
    "split_rhat",
    "rank_normalized_rhat",
    "device_trace",
    "PhaseTimer",
]
