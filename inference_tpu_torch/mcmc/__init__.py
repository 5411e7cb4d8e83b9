"""Sampler kernels (``_kernels``); the single-chain facades are not ported
yet (ROADMAP queue A7)."""
