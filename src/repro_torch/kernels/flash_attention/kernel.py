"""The Hopper flash-attention kernel, with its plain version.

:func:`flash_attention` launches the kernel written in CUDA C++ in
``repro_torch/csrc/flash_attention.cu`` (the source note there gives its
bound and design).  It replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``: online-softmax
attention, causal or not, with f32 statistics and accumulator, causal
queries aligned to the suffix of the keys.

Unlike the TPU kernel it takes the GQA layout itself (``q [B, Hq, Sq, D]``,
``k``/``v [B, Hkv, Skv, D]``; query head ``h`` reads KV head ``h // (Hq //
Hkv)``, nothing is expanded), reads every tensor through its strides, and
takes any sequence length.  The output has q's dtype and shape; on the card
it is laid out ``[B, Sq, Hq, D]`` in memory (a permuted view), so the
model's transpose back to ``[B, S, H, D]`` is free.

The wrapper takes its plain PyTorch version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; it never falls back.  It
counts its launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import library
from .ref import mha_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention", "flash_attention_plain"]

#: largest head dim the kernel takes (its widest shared-memory tiles)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # ``DType`` in the source
_MAX_GRID_Y = 65535


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores, softmax and P.V
    over the whole key axis (the oracle's arithmetic), cast to q's dtype."""
    return mha_ref(q, k, v, causal=causal, scale=scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("need q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D]")
    B, Hq, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with more queries ({Sq}) than keys "
                         f"({Skv}) leaves rows with no key")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k``, ``v [B, Hkv, Skv, D]``
    (any strides), ``[B, Hq, Sq, D]`` in q's dtype (CUDA kernel on the
    card).  Causal queries sit at key positions ``i + Skv - Sq``."""
    _check(q, k, v, causal)
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {sorted(map(str, _DTYPES))}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} not in [1, {MAX_HEAD_DIM}]")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"B * Hq = {B * Hq} exceeds {_MAX_GRID_Y}")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    if Sq == 0 or B * Hq == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over no keys")
    scale = (D ** -0.5) if scale is None else scale
    strides = (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(),
                                       *out.stride())
    fn = library("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, strides, int(causal),
                float(scale),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
