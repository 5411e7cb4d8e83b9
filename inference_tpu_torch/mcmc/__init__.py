"""Samplers: the batched transitions (``_kernels``) and the single-chain
``HamiltonianChain``, ``MetropolisChain``, ``GibbsChain`` and ``PcaChain``.
The other single-chain facades are not ported yet (ROADMAP queue A12,
A13)."""

from .gibbs import GibbsChain, MetropolisChain
from .hmc import HamiltonianChain
from .pca import PcaChain
from .utilities import Bounds, ChainProgressPrinter, effective_sample_size

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "HamiltonianChain",
    "Bounds",
    "effective_sample_size",
    "ChainProgressPrinter",
]
