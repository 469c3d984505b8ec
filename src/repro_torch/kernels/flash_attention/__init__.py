"""Flash attention: the CUDA kernel, its plain version, the reference and ops."""
