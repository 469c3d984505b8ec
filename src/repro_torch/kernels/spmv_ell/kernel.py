"""Hopper kernels of the windowed ELL pull-update, with their plain versions.

Kernels written in CUDA C++ in ``repro_torch/csrc/spmv_ell.cu`` (the source
note there gives each one's bound and design):

- :func:`ell_partials_masked` replaces the TPU kernel
  ``repro/kernels/spmv_ell/kernel.py::ell_partials_masked``: one partial
  reduction per ELL row.
- :func:`ell_partials_sentinel` replaces the TPU kernel
  ``repro/kernels/spmv_ell/kernel.py::ell_partials_sentinel``: the same
  partials with no mask plane, padding slots indexing an identity slot
  appended to each window.  It is the masked kernel's body with the mask
  test compiled out, so its partials are bitwise the masked ones.
- :func:`segment_combine` replaces the XLA segment combine after it
  (``repro/kernels/spmv_ell/ops.py::_segment_combine``): partials to
  destination rows, in a fixed order, without atomics.
- :func:`ell_partials_lanes` and :func:`ell_partials_ragged` are two
  wrappers of one lane kernel, which replaces the vmapped TPU kernel of
  the lane update (``repro/kernels/spmv_ell/ops.py::_update_lanes_jit``)
  and the ragged TPU kernel (``repro/kernels/spmv_ell/kernel.py::
  ell_partials_ragged``): ``[L, n_ell]`` partials for L message rows, one
  combine for every lane or one per lane.
- :func:`segment_combine_lanes` replaces the vmapped and the per-arm
  segment combines of those two updates: ``[L, rows]``.

Lane l of a lane kernel is bitwise the single-lane kernel on message row
l: the lane partials read each ELL row once for all lanes, with the lanes
on threads, and fold a lane's slots into the single-lane kernel's
accumulators in its order, then through its tree (the source note gives
the argument).
The lane kernels keep the lanes
side by side (lane-minor): they read the messages as ``[n, S]`` and write
the partials as ``[n_ell, S]``.  The public functions keep the
reference's ``[L, n]`` layout: they take that tensor or a
:class:`LaneMessages`, which makes the lane-minor copy once and keeps it
for every launch of an iteration, and return the partials as an ``[L,
n_ell]`` view of the lane-minor table (what :func:`segment_combine_lanes`
reads without a copy).

All take one shard or a batch of shards: each per-shard argument is a
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

__all__ = ["IDENTITY", "LaneMessages", "ell_partials_masked",
           "ell_partials_masked_plain", "ell_partials_sentinel",
           "ell_partials_sentinel_plain", "segment_combine",
           "segment_combine_plain", "ell_partials_lanes",
           "ell_partials_lanes_plain", "ell_partials_ragged",
           "ell_partials_ragged_plain", "segment_combine_lanes",
           "segment_combine_lanes_plain", "lane_chunk"]

IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_COMBINE_ID = {"sum": 0, "min": 1, "max": 2}
#: most shards one launch takes (``kMaxBatch`` in ``spmv_ell.cu``)
MAX_BATCH = 64
#: most distinct combine arms one lane launch takes (``kMaxArms``)
MAX_ARMS = 8
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
    _check(msgs, "msgs", (torch.float32,), 1)
    if msgs.numel() % window:
        raise ValueError("msgs do not cover whole windows")
    k = _check_ell(idx, mask, tile_window, msgs, tr)
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


def ell_partials_sentinel_plain(idx: Tensors, tile_window: Tensors, msgs, *,
                                window: int, tr: int,
                                combine: str) -> torch.Tensor:
    """Per-ELL-row partials, ``[sum n_ell]``: gather every slot, reduce
    over K (``window`` is the extended window, identity slots included)."""
    out = []
    for i, t in zip(_as_list(idx), _as_list(tile_window)):
        mask = torch.ones(i.shape, dtype=torch.bool, device=i.device)
        out.append(_partials_one(i, mask, t, msgs, window, tr, combine))
    return torch.cat(out)


def ell_partials_sentinel(idx: Tensors, tile_window: Tensors, msgs, *,
                          window: int, tr: int, combine: str) -> torch.Tensor:
    """Per-ELL-row partials with no mask plane, ``[sum n_ell]`` float32
    (CUDA kernel on the card).

    Per shard: ``idx`` int16/int32 ``[n_ell, K]`` indices into the
    extended window, padding slots pointing at an identity slot,
    ``tile_window`` int32 ``[n_ell // tr]``; ``msgs`` float32
    ``[num_windows * window]`` (``window`` = W + pad, the identity from
    column W of each window on) is shared.
    """
    idx, tile_window = _as_list(idx), _as_list(tile_window)
    if not idx or len(idx) != len(tile_window):
        raise ValueError("need one idx and tile_window per shard")
    if _on_cpu(*idx, *tile_window, msgs):
        return ell_partials_sentinel_plain(idx, tile_window, msgs,
                                           window=window, tr=tr,
                                           combine=combine)
    _check(msgs, "msgs", (torch.float32,), 1)
    if msgs.numel() % window:
        raise ValueError("msgs do not cover whole windows")
    k = _check_ell(idx, None, tile_window, msgs, tr)
    vec = k % _SLOTS_PER_LANE == 0 and all(t.data_ptr() % 16 == 0 for t in idx)
    out = torch.empty(sum(i.shape[0] for i in idx), dtype=torch.float32,
                      device=msgs.device)
    n_ell = (ctypes.c_longlong * len(idx))(*[i.shape[0] for i in idx])
    fn = library("spmv_ell").ell_partials_sentinel
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(msgs.device):
        rc = fn(_ptrs(idx), _ptrs(tile_window), n_ell, len(idx),
                idx[0].element_size(), int(vec), msgs.data_ptr(),
                out.data_ptr(), k, tr, window, _COMBINE_ID[combine],
                _stream(msgs.device))
    if rc != 0:
        raise RuntimeError(f"ell_partials_sentinel launch failed: CUDA error {rc}")
    ell_partials_sentinel.launches += 1
    return out


ell_partials_sentinel.launches = 0


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


# ------------------------------------------------------------------- lanes
_CUDA_INVALID_CONFIGURATION = 9  # ell_partials_lanes: the stride does not fit


def lane_chunk(n_lanes: int) -> int:
    """``NL``, 1, 4 or 8: the lane stride of the lane-minor message and
    partial tables is a multiple of it, and the lane partials' warp-per-row
    path holds that many lanes a thread at once."""
    return 1 if n_lanes == 1 else 4 if n_lanes <= 4 else 8


class LaneMessages:
    """A ``[L, n]`` lane-message matrix for the lane kernels.

    ``rows`` is the matrix in the reference's layout (what the plain
    versions read).  :meth:`vertex_major` is the kernels' lane-minor
    layout, ``[n, S]`` with the lane stride ``S`` a multiple of
    :func:`lane_chunk` (padding lanes zero), made on the matrix's device at
    first use and kept, so staging the lanes once an iteration stages them
    for every launch of it.
    """

    def __init__(self, rows: torch.Tensor):
        if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[0] < 1:
            raise ValueError(f"lane messages must be float32 [L >= 1, n], got "
                             f"{rows.dtype} {tuple(rows.shape)}")
        self.rows = rows
        self._vm = None
        self._uniform = None

    @property
    def lanes(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def vertex_major(self) -> torch.Tensor:
        if self._vm is None:
            n_lanes, n = self.rows.shape
            nl = lane_chunk(n_lanes)
            vm = torch.zeros((n, -(-n_lanes // nl) * nl), dtype=torch.float32,
                             device=self.rows.device)
            vm[:, :n_lanes] = self.rows.t()
            self._vm = vm
        return self._vm

    def uniform_ids(self) -> torch.Tensor:
        """Arm 0 for every lane, on the matrix's device."""
        if self._uniform is None:
            self._uniform = torch.zeros(self.lanes, dtype=torch.int32,
                                        device=self.rows.device)
        return self._uniform


def _lanes(msgs) -> LaneMessages:
    return msgs if isinstance(msgs, LaneMessages) else LaneMessages(msgs)


def _arm_ops(combines: Sequence[str]):
    if not 0 < len(combines) <= MAX_ARMS:
        raise ValueError(f"{len(combines)} combine arms; need 1..{MAX_ARMS}")
    return (ctypes.c_int * len(combines))(*[_COMBINE_ID[c] for c in combines])


def _lane_combines(combine_ids: torch.Tensor, combines: Sequence[str]):
    """Each lane's combine, None for a padding lane (id outside the arms)."""
    return [combines[c] if 0 <= c < len(combines) else None
            for c in combine_ids.tolist()]


def ell_partials_ragged_plain(idx: Tensors, mask: Tensors, tile_window: Tensors,
                              combine_ids: torch.Tensor, msgs, *, window: int,
                              tr: int, combines: Sequence[str]) -> torch.Tensor:
    """``[L, sum n_ell]``: lane l is :func:`ell_partials_masked_plain` on
    row l with its own combine, or zeros for a padding lane.  One lane's
    gather at a time."""
    rows = _lanes(msgs).rows
    n_ell = sum(i.shape[0] for i in _as_list(idx))
    out = []
    for l, c in enumerate(_lane_combines(combine_ids, combines)):
        out.append(torch.zeros(n_ell, dtype=rows.dtype, device=rows.device)
                   if c is None else ell_partials_masked_plain(
                       idx, mask, tile_window, rows[l], window=window, tr=tr,
                       combine=c))
    return torch.stack(out)


def ell_partials_lanes_plain(idx: Tensors, mask: Tensors, tile_window: Tensors,
                             msgs, *, window: int, tr: int,
                             combine: str) -> torch.Tensor:
    """``[L, sum n_ell]``: :func:`ell_partials_masked_plain` per lane."""
    rows = _lanes(msgs).rows
    return torch.stack([
        ell_partials_masked_plain(idx, mask, tile_window, rows[l],
                                  window=window, tr=tr, combine=combine)
        for l in range(rows.shape[0])])


def _launch_partials_lanes(name, idx, mask, tile_window, lanes: LaneMessages,
                           combine_ids, combines, window, tr):
    idx, mask, tile_window = _as_list(idx), _as_list(mask), _as_list(tile_window)
    k = _check_ell(idx, mask, tile_window, lanes.rows, tr)
    n_lanes = lanes.lanes
    if lanes.rows.shape[1] % window:
        raise ValueError("lane messages do not cover whole windows")
    _check(combine_ids, "combine_ids", (torch.int32,), 1)
    if combine_ids.numel() != n_lanes or combine_ids.device != lanes.device:
        raise ValueError(f"need {n_lanes} combine ids on {lanes.device}")
    vm = lanes.vertex_major()
    vec = k % _SLOTS_PER_LANE == 0 and all(
        t.data_ptr() % 16 == 0 for t in (*idx, *mask))
    n_ell_total = sum(i.shape[0] for i in idx)
    out = torch.empty((n_ell_total, vm.shape[1]), dtype=torch.float32,
                      device=vm.device)
    fn = library("spmv_ell").ell_partials_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    n_ell = (ctypes.c_longlong * len(idx))(*[i.shape[0] for i in idx])
    with torch.cuda.device(vm.device):
        rc = fn(_ptrs(idx), _ptrs(mask), _ptrs(tile_window), n_ell, len(idx),
                idx[0].element_size(), int(vec), vm.data_ptr(), vm.shape[1],
                n_lanes, lane_chunk(n_lanes), combine_ids.data_ptr(),
                _arm_ops(combines), len(combines), out.data_ptr(), k, tr,
                window, _stream(vm.device))
    if rc == _CUDA_INVALID_CONFIGURATION:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}: a lane stride "
                           f"of {vm.shape[1]} at K={k} needs more shared memory "
                           f"than a block has")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out.t()[:n_lanes]


def _lane_minor(part: torch.Tensor):
    """``part`` ``[L, n_ell]`` as a lane-minor table the lane combine reads:
    ``(table, lane stride)``.  The lane kernels' own output is one already;
    any other layout is copied."""
    n_lanes = part.shape[0]
    if n_lanes == 1 and part.stride(1) == 1:
        return part, 1
    if part.stride(0) == 1 and part.stride(1) >= n_lanes:
        return part, part.stride(1)
    return part.t().contiguous(), n_lanes


def _check_ell(idx, mask, tile_window, msgs, tr) -> int:
    """Shared checks of a batch's ELL planes (``mask`` None: no mask
    plane); returns K."""
    if mask is None:
        mask = [None] * len(idx)
    if not idx or not len(idx) == len(mask) == len(tile_window):
        raise ValueError("need one idx, mask and tile_window per shard")
    if len(idx) > MAX_BATCH:
        raise ValueError(f"{len(idx)} shards in one launch; at most {MAX_BATCH}")
    _check(idx[0], "idx", (torch.int16, torch.int32), 2)
    k = idx[0].shape[1]
    for i, m, t in zip(idx, mask, tile_window):
        _check(i, "idx", (idx[0].dtype,), 2)
        _check(t, "tile_window", (torch.int32,), 1)
        if m is not None:
            _check(m, "mask", (torch.bool,), 2)
            if m.shape != i.shape:
                raise ValueError(f"mask {tuple(m.shape)} does not match idx "
                                 f"{tuple(i.shape)}")
        rows = i.shape[0]
        if i.shape[1] != k or rows == 0 or rows % tr:
            raise ValueError(f"bad ELL shape {tuple(i.shape)} for K={k}, "
                             f"tr={tr}")
        if t.numel() * tr != rows:
            raise ValueError("tile_window does not cover the ELL rows")
    _check(msgs, "msgs", (torch.float32,), msgs.dim())
    return k


def ell_partials_lanes(idx: Tensors, mask: Tensors, tile_window: Tensors,
                       msgs, *, window: int, tr: int,
                       combine: str) -> torch.Tensor:
    """``[L, sum n_ell]`` partials for L message rows, one combine for
    every lane (CUDA kernel on the card; there the result is a view of a
    lane-minor table).  ``msgs`` is a float32 ``[L, num_windows * window]``
    tensor or a :class:`LaneMessages`; the ELL arguments are
    :func:`ell_partials_masked`'s."""
    lanes = _lanes(msgs)
    if _on_cpu(*_as_list(idx), *_as_list(mask), *_as_list(tile_window),
               lanes.rows):
        return ell_partials_lanes_plain(idx, mask, tile_window, lanes,
                                        window=window, tr=tr, combine=combine)
    out = _launch_partials_lanes("ell_partials_lanes", idx, mask, tile_window,
                                 lanes, lanes.uniform_ids(), (combine,),
                                 window, tr)
    ell_partials_lanes.launches += 1
    return out


ell_partials_lanes.launches = 0


def ell_partials_ragged(idx: Tensors, mask: Tensors, tile_window: Tensors,
                        combine_ids: torch.Tensor, msgs, *, window: int,
                        tr: int, combines: Sequence[str]) -> torch.Tensor:
    """``[L, sum n_ell]`` partials for the lanes of every fusion group in
    one launch: lane l folds with ``combines[combine_ids[l]]``; a lane
    whose id is outside the arms is a padding lane, written as 0 (CUDA
    kernel on the card)."""
    lanes = _lanes(msgs)
    if _on_cpu(*_as_list(idx), *_as_list(mask), *_as_list(tile_window),
               lanes.rows, combine_ids):
        return ell_partials_ragged_plain(idx, mask, tile_window, combine_ids,
                                         lanes, window=window, tr=tr,
                                         combines=combines)
    out = _launch_partials_lanes("ell_partials_ragged", idx, mask, tile_window,
                                 lanes, combine_ids, tuple(combines), window,
                                 tr)
    ell_partials_ragged.launches += 1
    return out


ell_partials_ragged.launches = 0


def segment_combine_lanes_plain(part: torch.Tensor, perm: Tensors,
                                row_ptr: Tensors, combines: Sequence[str],
                                combine_ids: torch.Tensor) -> torch.Tensor:
    """``[L, sum rows]``: :func:`segment_combine_plain` per lane with its
    own combine, zeros for a padding lane."""
    rows = sum(rp.numel() - 1 for rp in _as_list(row_ptr))
    out = []
    for l, c in enumerate(_lane_combines(combine_ids, combines)):
        out.append(torch.zeros(rows, dtype=part.dtype, device=part.device)
                   if c is None else segment_combine_plain(part[l], perm,
                                                           row_ptr, c))
    return torch.stack(out)


def segment_combine_lanes(part: torch.Tensor, perm: Tensors, row_ptr: Tensors,
                          combines: Sequence[str],
                          combine_ids: torch.Tensor = None) -> torch.Tensor:
    """Deterministic segment combine of ``[L, sum n_ell]`` lane partials
    into ``[L, sum rows]`` (CUDA kernel on the card): lane l with
    ``combines[combine_ids[l]]`` (arm 0 for every lane when
    ``combine_ids`` is None), padding lanes 0.  ``perm``/``row_ptr`` are
    :func:`segment_combine`'s.  On the card the kernel reads the partials
    lane-minor: the lane kernels' output is that already, any other
    layout is copied once."""
    perm, row_ptr = _as_list(perm), _as_list(row_ptr)
    if not perm or len(perm) != len(row_ptr):
        raise ValueError("need one perm and one row_ptr per shard")
    if part.dim() != 2:
        raise ValueError(f"lane partials must be [L, n_ell], got {tuple(part.shape)}")
    if combine_ids is None:
        combine_ids = torch.zeros(part.shape[0], dtype=torch.int32,
                                  device=part.device)
    if _on_cpu(part, *perm, *row_ptr, combine_ids):
        return segment_combine_lanes_plain(part, perm, row_ptr, combines,
                                           combine_ids)
    if len(perm) > MAX_BATCH:
        raise ValueError(f"{len(perm)} shards in one launch; at most {MAX_BATCH}")
    if part.dtype != torch.float32:
        raise TypeError(f"part: dtype {part.dtype} is not torch.float32")
    _check(combine_ids, "combine_ids", (torch.int32,), 1)
    n_lanes = part.shape[0]
    if combine_ids.numel() != n_lanes:
        raise ValueError(f"{combine_ids.numel()} combine ids for {n_lanes} lanes")
    for pm, rp in zip(perm, row_ptr):
        _check(pm, "perm", (torch.int32,), 1)
        _check(rp, "row_ptr", (torch.int32,), 1)
        if rp.numel() < 2:
            raise ValueError("row_ptr needs at least one destination row")
    if part.shape[1] != sum(pm.numel() for pm in perm):
        raise ValueError(f"{part.shape[1]} partials a lane for "
                         f"{sum(pm.numel() for pm in perm)} ELL rows")
    rows = [rp.numel() - 1 for rp in row_ptr]
    table, stride = _lane_minor(part)
    out = torch.empty((n_lanes, sum(rows)), dtype=torch.float32,
                      device=part.device)
    fn = library("spmv_ell").segment_combine_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    with torch.cuda.device(part.device):
        rc = fn(table.data_ptr(), stride, _ptrs(perm), _ptrs(row_ptr),
                (ctypes.c_longlong * len(perm))(*[pm.numel() for pm in perm]),
                (ctypes.c_int * len(rows))(*rows), len(perm), n_lanes,
                combine_ids.data_ptr(), _arm_ops(combines), len(combines),
                out.data_ptr(), _stream(part.device))
    if rc != 0:
        raise RuntimeError(f"segment_combine_lanes launch failed: CUDA error {rc}")
    segment_combine_lanes.launches += 1
    return out


segment_combine_lanes.launches = 0
