from .chain_array import ChainArray

__all__ = ["ChainArray"]
