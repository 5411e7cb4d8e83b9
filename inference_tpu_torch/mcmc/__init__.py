"""Samplers: the batched transitions (``_kernels``), the single-chain
``HamiltonianChain``, ``MetropolisChain``, ``GibbsChain`` and ``PcaChain``,
the ``EnsembleSampler`` and the one-device ``ParallelTempering`` and
``ChainPool``. ``NutsChain`` is not ported yet (ROADMAP queue A12)."""

from .gibbs import GibbsChain, MetropolisChain
from .pca import PcaChain
from .ensemble import EnsembleSampler
from .hmc import HamiltonianChain
from .parallel import ChainPool, ParallelTempering
from .utilities import Bounds, ChainProgressPrinter, effective_sample_size

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "EnsembleSampler",
    "HamiltonianChain",
    "ParallelTempering",
    "ChainPool",
    "Bounds",
    "effective_sample_size",
    "ChainProgressPrinter",
]
