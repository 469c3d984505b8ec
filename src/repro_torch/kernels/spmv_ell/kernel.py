"""Hopper kernels of the windowed ELL pull-update, with their plain versions.

Two kernels, written in CUDA C++ in ``repro_torch/csrc/spmv_ell.cu`` (the
source note there gives each one's bound and design):

- :func:`ell_partials_masked` replaces the TPU kernel
  ``repro/kernels/spmv_ell/kernel.py::ell_partials_masked``: one partial
  reduction per ELL row.
- :func:`segment_combine` replaces the XLA segment combine after it
  (``repro/kernels/spmv_ell/ops.py::_segment_combine``): partials to
  destination rows, in a fixed order, without atomics.

Both take one shard or a batch of shards: each per-shard argument is a
tensor or a sequence of tensors, one per shard, and a batch is one launch
over the shards' own tensors (nothing is concatenated on the card).  The
partials of a batch come out concatenated in shard order, and so do the
destination rows.

Each wrapper takes its plain PyTorch version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; it never falls back.  Each
wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import torch

from ..build import library

__all__ = ["IDENTITY", "ell_partials_masked", "ell_partials_masked_plain",
           "segment_combine", "segment_combine_plain"]

IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_COMBINE_ID = {"sum": 0, "min": 1, "max": 2}
#: most shards one launch takes (``kMaxBatch`` in ``spmv_ell.cu``)
MAX_BATCH = 64
_SLOTS_PER_LANE = 16  # ``kSlotsPerLane``: K must be a multiple for the vector path

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_list(x: Tensors) -> List[torch.Tensor]:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; raises on a mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------- partials
def _partials_one(idx, mask, tile_window, msgs, window, tr, combine):
    win = torch.repeat_interleave(tile_window.to(torch.int64), tr)
    gidx = idx.to(torch.int64).clamp_(0, window - 1) + win[:, None] * window
    g = torch.where(mask, msgs[gidx], IDENTITY[combine])
    if combine == "sum":
        return g.sum(dim=1)
    if combine == "min":
        return g.amin(dim=1)
    return g.amax(dim=1)


def ell_partials_masked_plain(idx: Tensors, mask: Tensors, tile_window: Tensors,
                              msgs, *, window: int, tr: int,
                              combine: str) -> torch.Tensor:
    """Per-ELL-row partials, ``[sum n_ell]``: gather, mask, reduce over K."""
    return torch.cat([
        _partials_one(i, m, t, msgs, window, tr, combine)
        for i, m, t in zip(_as_list(idx), _as_list(mask), _as_list(tile_window))])


def ell_partials_masked(idx: Tensors, mask: Tensors, tile_window: Tensors,
                        msgs, *, window: int, tr: int,
                        combine: str) -> torch.Tensor:
    """Per-ELL-row partials, ``[sum n_ell]`` float32 (CUDA kernel on the card).

    Per shard: ``idx`` int16/int32 ``[n_ell, K]`` window-local indices,
    ``mask`` bool ``[n_ell, K]``, ``tile_window`` int32 ``[n_ell // tr]``;
    ``msgs`` float32 ``[num_windows * window]`` is shared.
    """
    idx, mask, tile_window = _as_list(idx), _as_list(mask), _as_list(tile_window)
    if not idx or not len(idx) == len(mask) == len(tile_window):
        raise ValueError("need one idx, mask and tile_window per shard")
    if _on_cpu(*idx, *mask, *tile_window, msgs):
        return ell_partials_masked_plain(idx, mask, tile_window, msgs,
                                         window=window, tr=tr, combine=combine)
    if len(idx) > MAX_BATCH:
        raise ValueError(f"{len(idx)} shards in one launch; at most {MAX_BATCH}")
    _check(msgs, "msgs", (torch.float32,), 1)
    if msgs.numel() % window:
        raise ValueError("msgs do not cover whole windows")
    _check(idx[0], "idx", (torch.int16, torch.int32), 2)
    k = idx[0].shape[1]
    for i, m, t in zip(idx, mask, tile_window):
        _check(i, "idx", (idx[0].dtype,), 2)
        _check(m, "mask", (torch.bool,), 2)
        _check(t, "tile_window", (torch.int32,), 1)
        rows = i.shape[0]
        if m.shape != i.shape or i.shape[1] != k or rows == 0 or rows % tr:
            raise ValueError(f"bad ELL shape {tuple(i.shape)} / mask "
                             f"{tuple(m.shape)} for K={k}, tr={tr}")
        if t.numel() * tr != rows:
            raise ValueError("tile_window does not cover the ELL rows")
    vec = k % _SLOTS_PER_LANE == 0 and all(
        t.data_ptr() % 16 == 0 for t in (*idx, *mask))
    out = torch.empty(sum(i.shape[0] for i in idx), dtype=torch.float32,
                      device=msgs.device)
    n_ell = (ctypes.c_longlong * len(idx))(*[i.shape[0] for i in idx])
    fn = library("spmv_ell").ell_partials_masked
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(msgs.device):
        rc = fn(_ptrs(idx), _ptrs(mask), _ptrs(tile_window), n_ell, len(idx),
                idx[0].element_size(), int(vec), msgs.data_ptr(),
                out.data_ptr(), k, tr, window, _COMBINE_ID[combine],
                _stream(msgs.device))
    if rc != 0:
        raise RuntimeError(f"ell_partials_masked launch failed: CUDA error {rc}")
    ell_partials_masked.launches += 1
    return out


ell_partials_masked.launches = 0


# ----------------------------------------------------------------- combine
def segment_combine_plain(part, perm: Tensors, row_ptr: Tensors,
                          combine: str) -> torch.Tensor:
    """``out[r]`` = COMBINE of shard ``s``'s partials at
    ``perm[row_ptr[r]:row_ptr[r+1]]``, the identity for an empty row;
    ``[sum rows]``.  Shard ``s``'s partials follow those of the shards
    before it in ``part``, ``perm[s].numel()`` of them."""
    out, ell0 = [], 0
    for pm, rp in zip(_as_list(perm), _as_list(row_ptr)):
        n = int(rp[-1])
        data = part[ell0 + pm[:n].to(torch.int64)]
        lengths = (rp[1:] - rp[:-1]).to(torch.int64)
        out.append(torch.segment_reduce(data, combine, lengths=lengths,
                                        initial=IDENTITY[combine]))
        ell0 += pm.numel()
    return torch.cat(out)


def segment_combine(part, perm: Tensors, row_ptr: Tensors,
                    combine: str) -> torch.Tensor:
    """Deterministic segment combine of ELL-row partials into
    ``[sum rows]`` (CUDA kernel on the card).  Per shard, ``perm`` int32
    ``[n_ell]`` lists its ELL rows grouped by destination row, ascending
    within each, and ``row_ptr`` int32 ``[rows + 1]`` bounds each
    destination row's run of ``perm``."""
    perm, row_ptr = _as_list(perm), _as_list(row_ptr)
    if not perm or len(perm) != len(row_ptr):
        raise ValueError("need one perm and one row_ptr per shard")
    if _on_cpu(part, *perm, *row_ptr):
        return segment_combine_plain(part, perm, row_ptr, combine)
    if len(perm) > MAX_BATCH:
        raise ValueError(f"{len(perm)} shards in one launch; at most {MAX_BATCH}")
    _check(part, "part", (torch.float32,), 1)
    for pm, rp in zip(perm, row_ptr):
        _check(pm, "perm", (torch.int32,), 1)
        _check(rp, "row_ptr", (torch.int32,), 1)
        if rp.numel() < 2:
            raise ValueError("row_ptr needs at least one destination row")
    if part.numel() != sum(pm.numel() for pm in perm):
        raise ValueError(f"{part.numel()} partials for "
                         f"{sum(pm.numel() for pm in perm)} ELL rows")
    rows = [rp.numel() - 1 for rp in row_ptr]
    out = torch.empty(sum(rows), dtype=torch.float32, device=part.device)
    fn = library("spmv_ell").segment_combine
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(part.device):
        rc = fn(part.data_ptr(), _ptrs(perm), _ptrs(row_ptr),
                (ctypes.c_longlong * len(perm))(*[pm.numel() for pm in perm]),
                (ctypes.c_int * len(rows))(*rows), len(perm), out.data_ptr(),
                _COMBINE_ID[combine], _stream(part.device))
    if rc != 0:
        raise RuntimeError(f"segment_combine launch failed: CUDA error {rc}")
    segment_combine.launches += 1
    return out


segment_combine.launches = 0
