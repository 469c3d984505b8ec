"""Batched Bloom-filter membership: CUDA kernel, plain version, ops."""
