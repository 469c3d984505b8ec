"""The Hopper flash-attention kernels, with their plain versions.

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

:func:`flash_decode` launches the kernel in ``repro_torch/csrc/
flash_decode.cu``.  It replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_decode``: single-token GQA
decode over a masked cache, in the reference's layout (``q [BHkv, G, D]``,
``k``/``v [BHkv, S, D]``, ``valid [BHkv, S]``), for any S.  On the card the
key axis is split across CTAs and, in the same launch, the last CTA of
each row merges its splits in a fixed order (:func:`flash_decode_combine`'s
algebra).  :func:`decode_partials_ref` and
:func:`flash_decode_combine` are the reference's jnp helpers in torch.

On the card each call takes one of two kernels, chosen before the launch
by dtype, shape and layout alone (:func:`uses_tensor_cores`,
:func:`decode_uses_tensor_cores`): bf16 calls on 16 B aligned rows at head
dim 64 or 128 (decode: also 256, at most 16 query heads a kv head) run
the tensor-core kernel on bf16 tiles in shared memory (``wgmma`` for
attention, ``mma.sync`` for decode); every other call runs the scalar f32
kernel, so f32 inputs keep f32 products.

Each wrapper takes its plain PyTorch version for CPU tensors only.  For
CUDA tensors it launches a kernel or raises; it never falls back.  Each
counts its launches in its ``launches`` attribute, and the tensor-core
kernel's among them in ``tc_launches``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..build import library
from .ref import mha_ref

__all__ = ["DECODE_TC_HEAD_DIMS", "MAX_DECODE_GROUP", "MAX_HEAD_DIM", "NEG_INF",
           "TC_HEAD_DIMS", "decode_partials_ref", "decode_splits",
           "decode_uses_tensor_cores", "flash_attention", "flash_attention_plain",
           "flash_decode", "flash_decode_combine", "flash_decode_plain",
           "uses_tensor_cores"]

#: largest head dim the kernel takes (its widest shared-memory tiles)
MAX_HEAD_DIM = 256
#: head dims the tensor-core attention kernel is built for (at 256 its
#: registers spill: that head dim stays on the scalar kernel)
TC_HEAD_DIMS = (64, 128)
#: head dims the tensor-core decode kernel is built for
DECODE_TC_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # ``DType`` in the source
_MAX_GRID_Y = 65535
#: the reference's masked score: finite, so a row with no valid slot stays 0
NEG_INF = -1e30
#: most query heads per kv head the decode kernel takes (``kMaxG``)
MAX_DECODE_GROUP = 32
#: CTAs the decode kernel aims at, over all rows and splits: two a
#: streaming multiprocessor of an H100 (132), the ring kernel's occupancy at
#: D = 128 (a wave; more splits only lengthen the merge)
_DECODE_TARGET_CTAS = 264
#: keys a decode tile, the unit of a split (``kTileKeys`` in the source)
_DECODE_TILE = 64
#: most tiles a split (``kMaxTiles``: the ring kernel lists them in shared
#: memory)
_DECODE_MAX_TILES = 256
#: query rows of the decode kernel's tensor-core tile (``ring::kRows``)
_DECODE_TC_GROUP = 16
#: (device index, stream) -> the decode kernel's row tickets, zero between
#: launches; one array a stream, so concurrent launches never share one
_DECODE_TICKETS: dict = {}
_DECODE_TICKETS_LOCK = threading.Lock()


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


def _rows_aligned(t: torch.Tensor) -> bool:
    """Last stride 1; base pointer and every other stride 16 B aligned."""
    esize = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * esize % 16 == 0 for st in t.stride()[:-1]))


def uses_tensor_cores(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of :func:`flash_attention` on the card, for its q,
    k, v and output: bf16, head dim in :data:`TC_HEAD_DIMS`, and every
    tensor's rows 16 B aligned (last stride 1, base pointer and other
    strides multiples of 16 B).  Such a call runs the tensor-core kernel,
    every other call the scalar one.  Depends on dtype, shape and layout
    only (``flash_attention_fwd_tc`` checks the same)."""
    q = tensors[0]
    return (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(t.dtype == q.dtype and _rows_aligned(t) for t in tensors))


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
    tc = uses_tensor_cores(q, k, v, out)
    lib = library("flash_attention")
    ptrs = [ctypes.c_void_p] * 4
    if tc:
        fn = lib.flash_attention_fwd_tc
        fn.argtypes = ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        head = ()
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = ptrs + [ctypes.c_int] * 7 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        head = (_DTYPES[q.dtype],)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *head,
                B, Hq, Hkv, Sq, Skv, D, strides, int(causal), float(scale),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0


# ------------------------------------------------------------------ decode
def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, *,
                        scale: Optional[float] = None):
    """``(o_unnormalised [BH, G, D], m [BH, G], l [BH, G])`` in f32 over
    one shard of the cache: the partials :func:`flash_decode_combine`
    merges.  Masked scores are ``NEG_INF`` and their ``p`` is 0."""
    D = q.shape[-1]
    scale = (D ** -0.5) if scale is None else scale
    s = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) * scale
    vm = valid[:, None, :]
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bgk,bkd->bgd", p, v.float())
    return o, m, p.sum(dim=-1)


def flash_decode_combine(os: torch.Tensor, ms: torch.Tensor,
                         ls: torch.Tensor) -> torch.Tensor:
    """Merge N shards' partials (``os [N, BH, G, D]`` un-normalised, ``ms``
    and ``ls [N, BH, G]``) into the normalised ``[BH, G, D]`` output."""
    m_star = ms.amax(dim=0)
    w = torch.exp(ms - m_star[None])
    l_tot = (ls * w).sum(dim=0)
    o_tot = (os * w[..., None]).sum(dim=0)
    return o_tot / l_tot.clamp_min(1e-30)[..., None]


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The decode kernel's function in plain PyTorch: the partials over the
    whole cache, normalised (``l`` clamped at 1e-30), in q's dtype."""
    o, _, l = decode_partials_ref(q, k, v, valid, scale=scale)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def decode_splits(S: int, BH: int, D: int):
    """``(splits, tiles_per_split, tile)``: how the decode kernels cut S
    keys into whole tiles of ``tile`` keys per split, about
    ``_DECODE_TARGET_CTAS`` CTAs in all, at most ``_DECODE_MAX_TILES``
    tiles a split and no split empty.  Both kernels take the same cut (D
    does not change it).  Depends only on the shapes, so a result never
    changes with the card or the kernel."""
    tile = _DECODE_TILE
    n_tiles = -(-S // tile)
    want = min(n_tiles, max(1, -(-_DECODE_TARGET_CTAS // BH)))
    per = min(-(-n_tiles // want), _DECODE_MAX_TILES)
    return -(-n_tiles // per), per, tile


def decode_uses_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> bool:
    """The dispatch rule of :func:`flash_decode` on the card: bf16, head dim
    in :data:`DECODE_TC_HEAD_DIMS`, at most 16 query heads a kv head, and
    q, k, v 16 B aligned (they are contiguous, so their rows are too).
    Such a call runs the ring kernel, every other call the scalar one.
    Depends on dtype, shape and layout only (the source checks the same)."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in DECODE_TC_HEAD_DIMS
            and q.shape[1] <= _DECODE_TC_GROUP
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _decode_tickets(dev: torch.device, BH: int) -> torch.Tensor:
    """The current stream's row tickets on ``dev``, at least ``BH`` of them.
    A new array is zeroed on that stream, so it is ordered before the
    launch that takes it; the kernel leaves every ticket at 0."""
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    with _DECODE_TICKETS_LOCK:
        t = _DECODE_TICKETS.get(key)
        if t is None or t.numel() < BH:
            t = torch.zeros(max(BH, 64), dtype=torch.int32, device=dev)
            _DECODE_TICKETS[key] = t
        return t


def _check_decode(q, k, v, valid) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or valid.dim() != 2:
        raise ValueError("need q [BH, G, D], k, v [BH, S, D], valid [BH, S]")
    BH, G, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if tuple(valid.shape) != (BH, k.shape[1]):
        raise ValueError(f"valid {tuple(valid.shape)} is not [{BH}, {k.shape[1]}]")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid: dtype {valid.dtype} is not bool")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[1] == 0:
        raise ValueError("decode over an empty cache")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention of ``q [BH, G, D]`` (the G query heads
    of each kv head) over ``k``, ``v [BH, S, D]`` where ``valid [BH, S]``,
    normalised, ``[BH, G, D]`` in q's dtype (CUDA kernel on the card)."""
    _check_decode(q, k, v, valid)
    devs = {t.device for t in (q, k, v, valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return flash_decode_plain(q, k, v, valid, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not in {sorted(map(str, _DTYPES))}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    BH, G, D = q.shape
    S = k.shape[1]
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} not in [1, {MAX_HEAD_DIM}]")
    if not 1 <= G <= MAX_DECODE_GROUP:
        raise ValueError(f"group {G} not in [1, {MAX_DECODE_GROUP}]")
    if not 1 <= BH <= _MAX_GRID_Y:
        raise ValueError(f"BH = {BH} not in [1, {_MAX_GRID_Y}]")
    splits, per, _ = decode_splits(S, BH, D)
    out = torch.empty_like(q)
    scratch = [None] * 4  # partials and tickets, only where splits merge
    with torch.cuda.device(dev):
        if splits > 1:
            po = torch.empty((splits, BH, G, D), dtype=torch.float32, device=dev)
            pm = torch.empty((splits, BH, G), dtype=torch.float32, device=dev)
            pl = torch.empty_like(pm)
            scratch = [po.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                       _decode_tickets(dev, BH).data_ptr()]
        tc = decode_uses_tensor_cores(q, k, v)
        # 2: the ring kernel; 1: the scalar one with 16 B loads of k; 0: scalar
        path = 2 if tc else int(D in DECODE_TC_HEAD_DIMS and k.data_ptr() % 16 == 0)
        scale = (D ** -0.5) if scale is None else scale
        fn = library("flash_decode").flash_decode
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), *scratch, _DTYPES[q.dtype], BH, G, S, D, splits,
                per, path, float(scale),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {rc}")
    flash_decode.launches += 1
    flash_decode.tc_launches += tc
    return out


flash_decode.launches = 0
flash_decode.tc_launches = 0
