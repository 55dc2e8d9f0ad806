"""Tensor ops of the port: norms, rope, attention, sampling, paged attention and kernel K1."""
