"""GraphMP on PyTorch and CUDA: the port of the ``repro`` package.

It imports torch, numpy and the standard library only.  Entry points run on
the CUDA card by default and raise where there is none; pass
``device="cpu"`` to run on the CPU.
"""
