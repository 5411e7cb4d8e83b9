"""Samplers: the batched transitions (``_kernels``), the single-chain
``HamiltonianChain``, ``NutsChain``, ``MetropolisChain``, ``GibbsChain`` and
``PcaChain``, the ``EnsembleSampler`` and the one-device
``ParallelTempering`` and ``ChainPool``."""

from .gibbs import GibbsChain, MetropolisChain
from .pca import PcaChain
from .ensemble import EnsembleSampler
from .hmc import HamiltonianChain
from .nuts import NutsChain
from .parallel import ChainPool, ParallelTempering
from .utilities import Bounds, ChainProgressPrinter, effective_sample_size

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "EnsembleSampler",
    "HamiltonianChain",
    "NutsChain",
    "ParallelTempering",
    "ChainPool",
    "Bounds",
    "effective_sample_size",
    "ChainProgressPrinter",
]
