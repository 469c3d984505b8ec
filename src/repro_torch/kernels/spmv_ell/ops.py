"""Public entry points of the ELL pull-update: the ``cuda`` backend.

``ell_update_batched`` runs N consecutive planned shards (DESIGN.md §4)
through ONE launch of the partials kernel and one of the segment combine,
each reading every shard's own device tensors, and returns the
destination rows of all N in shard order; the executor runs every
dispatch through it.  ``ell_update`` is the same for one shard.
``stage_messages`` copies an iteration's message array to the device once,
padded to whole windows.

The serving layer's lane update (DESIGN.md §6, §9, §14) carries a lane
axis: ``[L, |V|]`` messages, ``[L, rows]`` accumulators.

- ``ell_update_lanes_batched`` (``ell_update_lanes`` for one shard) runs L
  lanes of one combine through one launch of the lane partials kernel and
  one of the lane combine; ``ell_update_lanes_multi`` does so once per
  program group.
- ``ragged_stage_lanes`` / ``ragged_dispatch`` / ``ragged_collect`` are the
  ragged path: every group's lanes concatenated once an iteration, each
  lane with its combine arm, one launch of each kernel per shard batch.
  ``ell_update_lanes_ragged`` chains the three.  Per group it is bitwise
  ``ell_update_lanes_multi``.

On the card these launch the CUDA kernels; on CPU tensors the kernels'
plain versions run in their place.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ...core.csr import DeviceEll, ragged_lane_concat, ragged_lane_pad
from . import kernel as K

__all__ = ["ell_update", "ell_update_batched", "stage_messages", "stage_lanes",
           "ell_update_lanes", "ell_update_lanes_batched",
           "ell_update_lanes_multi", "ragged_stage_lanes", "ragged_dispatch",
           "ragged_collect", "ell_update_lanes_ragged", "split_rows"]


def stage_messages(msgs: np.ndarray, n_pad: int, device) -> torch.Tensor:
    """``msgs`` zero-padded to ``n_pad`` (whole windows) as float32 on
    ``device``.  To a CUDA device the copy goes through pinned memory and
    is asynchronous on the current stream."""
    device = torch.device(device)
    if msgs.shape[0] > n_pad:
        raise ValueError(f"{msgs.shape[0]} messages exceed the padded {n_pad}")
    host = torch.empty(n_pad, dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    view = host.numpy()
    view[: msgs.shape[0]] = msgs
    view[msgs.shape[0]:] = 0.0
    return host.to(device, non_blocking=True)


def _check_batch(ells: Sequence[DeviceEll]) -> DeviceEll:
    if not ells:
        raise ValueError("empty ELL batch")
    first = ells[0]
    for e in ells[1:]:
        if (e.window, e.k, e.tr, e.num_vertices) != (
                first.window, first.k, first.tr, first.num_vertices):
            raise ValueError("ELL shards in a batch must share window/k/tr/|V|")
    return first


def ell_update_batched(ells: Sequence[DeviceEll], msgs: torch.Tensor,
                       combine: str) -> torch.Tensor:
    """``acc[sum rows]``: the destination rows of every shard of ``ells``,
    in order; ``msgs`` is the staged ``[num_windows * window]`` message
    array on the same device.  Bitwise equal to one :func:`ell_update` per
    shard, concatenated."""
    first = _check_batch(ells)
    part = K.ell_partials_masked([e.idx for e in ells], [e.mask for e in ells],
                                 [e.tile_window for e in ells], msgs,
                                 window=first.window, tr=first.tr,
                                 combine=combine)
    return K.segment_combine(part, [e.perm for e in ells],
                             [e.row_ptr for e in ells], combine)


def ell_update(ell: DeviceEll, msgs: torch.Tensor, combine: str) -> torch.Tensor:
    """``acc[rows]`` for one device shard."""
    return ell_update_batched([ell], msgs, combine)


# --------------------------------------------------------------------- lanes
def _pinned(shape, device: torch.device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")


def stage_lanes(msgs: np.ndarray, n_pad: int, device) -> K.LaneMessages:
    """``[L, |V|]`` messages zero-padded to ``n_pad`` columns (whole
    windows) on ``device``, ready for the lane kernels.  To a CUDA device
    the copy goes through pinned memory and is asynchronous."""
    device = torch.device(device)
    if msgs.ndim != 2:
        raise ValueError(f"lane update needs [lanes, |V|] messages, got {msgs.shape}")
    if msgs.shape[1] > n_pad:
        raise ValueError(f"{msgs.shape[1]} messages exceed the padded {n_pad}")
    host = _pinned((msgs.shape[0], n_pad), device)
    view = host.numpy()
    view[:, : msgs.shape[1]] = msgs
    view[:, msgs.shape[1]:] = 0.0
    return K.LaneMessages(host.to(device, non_blocking=True))


def split_rows(ells: Sequence[DeviceEll], acc: np.ndarray) -> List[np.ndarray]:
    """Slice a batch's accumulator (rows on the trailing axis) per shard."""
    return np.split(acc, np.cumsum([e.rows for e in ells[:-1]]), axis=-1)


def ell_update_lanes_batched(ells: Sequence[DeviceEll], msgs,
                             combine: str) -> torch.Tensor:
    """``acc[L, sum rows]`` for every shard of ``ells`` against L message
    rows (``[L, num_windows * window]`` on the shards' device, or their
    :class:`~repro_torch.kernels.spmv_ell.kernel.LaneMessages`).  Lane l is
    bitwise :func:`ell_update_batched` on row l."""
    first = _check_batch(ells)
    lanes = K._lanes(msgs)
    part = K.ell_partials_lanes([e.idx for e in ells], [e.mask for e in ells],
                                [e.tile_window for e in ells], lanes,
                                window=first.window, tr=first.tr,
                                combine=combine)
    return K.segment_combine_lanes(part, [e.perm for e in ells],
                                   [e.row_ptr for e in ells], (combine,),
                                   lanes.uniform_ids())


def ell_update_lanes(ell: DeviceEll, msgs, combine: str) -> torch.Tensor:
    """``acc[L, rows]`` for one device shard."""
    return ell_update_lanes_batched([ell], msgs, combine)


def ell_update_lanes_multi(ells: Sequence[DeviceEll],
                           msgs_by_group: Sequence[np.ndarray],
                           combines: Sequence[str]) -> List[List[np.ndarray]]:
    """Per-shard ``[K_g, rows]`` accumulators for N shards x G program
    groups: one lane launch of each kernel per group, each against that
    group's ``[K_g, |V|]`` messages and combine."""
    if len(msgs_by_group) != len(combines):
        raise ValueError("one combine per message group")
    if not ells:
        return [[] for _ in msgs_by_group]
    first = _check_batch(ells)
    n_pad = first.num_windows * first.window
    out = []
    for msgs, combine in zip(msgs_by_group, combines):
        acc = ell_update_lanes_batched(
            ells, stage_lanes(msgs, n_pad, first.device), combine)
        out.append(split_rows(ells, acc.cpu().numpy()))
    return out


def ragged_stage_lanes(msgs_by_group: Sequence[np.ndarray],
                       combines: Sequence[str], n_pad_v: int, device):
    """Stage the lane side of a ragged launch on ``device`` ONCE: every
    group's lanes concatenated (:func:`~repro_torch.core.csr.
    ragged_lane_concat`), padded to whole windows, with each lane's arm id.
    Lane values are fixed within a sweep iteration, so the executor reuses
    this for every shard batch."""
    device = torch.device(device)
    for msgs in msgs_by_group:
        if msgs.ndim != 2:
            raise ValueError(
                f"lane update needs [lanes, |V|] messages, got {msgs.shape}")
    k_total = int(sum(int(m.shape[0]) for m in msgs_by_group))
    host = _pinned((ragged_lane_pad([m.shape[0] for m in msgs_by_group]),
                    n_pad_v), device)
    _, cids, combines_set, slices = ragged_lane_concat(
        msgs_by_group, combines, n_cols=n_pad_v, out=host.numpy())
    return {
        "msgs": K.LaneMessages(host.to(device, non_blocking=True)),
        "cids": torch.from_numpy(cids).to(device),
        "combines": combines_set,
        "slices": slices,
        "k_total": k_total,
        "k_pad": int(host.shape[0]),
    }


def ragged_dispatch(ells: Sequence[DeviceEll], lane_ctx) -> torch.Tensor:
    """Launch ONE ragged update for a shard batch: ``acc[k_pad, sum
    rows]``, left on the device so the caller can stage the next batch
    while it runs (the double buffer, DESIGN.md §14)."""
    first = _check_batch(ells)
    part = K.ell_partials_ragged(
        [e.idx for e in ells], [e.mask for e in ells],
        [e.tile_window for e in ells], lane_ctx["cids"], lane_ctx["msgs"],
        window=first.window, tr=first.tr, combines=lane_ctx["combines"])
    return K.segment_combine_lanes(part, [e.perm for e in ells],
                                   [e.row_ptr for e in ells],
                                   lane_ctx["combines"], lane_ctx["cids"])


def ragged_collect(ells: Sequence[DeviceEll], acc, group_slices
                   ) -> List[List[np.ndarray]]:
    """A ragged accumulator (a tensor or a host array) sliced back per
    group per shard, the shape :func:`ell_update_lanes_multi` returns."""
    if isinstance(acc, torch.Tensor):
        acc = acc.cpu().numpy()  # waits for the launch
    return [split_rows(ells, acc[sl]) for sl in group_slices]


def ell_update_lanes_ragged(ells: Sequence[DeviceEll],
                            msgs_by_group: Sequence[np.ndarray],
                            combines: Sequence[str]) -> List[List[np.ndarray]]:
    """Per-shard ``[K_g, rows]`` accumulators for N shards x G groups from
    ONE launch of each kernel (the ragged replacement for
    :func:`ell_update_lanes_multi`'s G launches); bitwise equal to it per
    group."""
    if len(msgs_by_group) != len(combines):
        raise ValueError("one combine per message group")
    if not ells:
        return [[] for _ in msgs_by_group]
    first = _check_batch(ells)
    ctx = ragged_stage_lanes(msgs_by_group, combines,
                             first.num_windows * first.window, first.device)
    return ragged_collect(ells, ragged_dispatch(ells, ctx), ctx["slices"])
