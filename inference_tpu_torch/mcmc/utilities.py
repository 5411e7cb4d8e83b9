"""Compatibility module mirroring the reference ``inference.mcmc.utilities``
surface, as ``inference_tpu.mcmc.utilities`` does: ``Bounds``,
``effective_sample_size`` and ``ChainProgressPrinter``."""

from ..utils.bounds import Bounds
from ..utils.ess import effective_sample_size
from ..utils.progress import ChainProgressPrinter

__all__ = ["Bounds", "effective_sample_size", "ChainProgressPrinter"]
