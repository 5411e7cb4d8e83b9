from .mesh import chain_mesh, tempering_mesh
from .chain_array import ChainArray
from .tempering import ShardedTempering
from .multihost import initialize_multihost, global_chain_mesh, global_tempering_mesh

__all__ = [
    "chain_mesh",
    "tempering_mesh",
    "ChainArray",
    "ShardedTempering",
    "initialize_multihost",
    "global_chain_mesh",
    "global_tempering_mesh",
]
