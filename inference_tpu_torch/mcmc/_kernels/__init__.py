"""Batched sampler transitions: ``(state) -> (state, output)`` step
functions over a leading chain axis."""
