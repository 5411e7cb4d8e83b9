"""Samplers: the batched transitions (``_kernels``) and the single-chain
``HamiltonianChain``. The other single-chain facades are not ported yet
(ROADMAP queue A12, A13)."""

from .hmc import HamiltonianChain
from .utilities import Bounds, ChainProgressPrinter, effective_sample_size

__all__ = ["HamiltonianChain", "Bounds", "effective_sample_size", "ChainProgressPrinter"]
