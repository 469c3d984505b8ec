"""Windowed row-split ELL pull-update: CUDA kernels, plain versions, ops."""
