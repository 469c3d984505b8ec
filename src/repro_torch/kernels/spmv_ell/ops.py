"""Public entry points of the ELL pull-update: the ``cuda`` backend.

``ell_update_batched`` runs N consecutive planned shards (DESIGN.md §4)
through ONE launch of the partials kernel and one of the segment combine,
each reading every shard's own device tensors, and returns the
destination rows of all N in shard order; the executor runs every
dispatch through it.  ``ell_update`` is the same for one shard.
``stage_messages`` copies an iteration's message array to the device once,
padded to whole windows.

``variant="sentinel"`` runs the same update through the sentinel layout
(the reference's ``ell_update(variant="sentinel")``): no mask plane; each
shard's :meth:`~repro_torch.core.csr.DeviceEll.sentinel_idx` points padding
slots at an identity slot, and each call stages the messages once more
with :data:`SENTINEL_PAD` identity slots after every window
(:func:`extend_windows`).  The reference pads by 128 for TPU lane
alignment; 8 floats keep every window 32 B aligned, so the gathers touch
the sectors they touch in the masked layout.  Its results are bitwise
the masked variant's.

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

The mesh steps (DESIGN.md §10) run the same updates over the slots of a
:class:`~repro_torch.launch.mesh.Mesh` from one process: ``device_ells[d]``
holds the shards slot ``d`` owns this round, already on the slot's device.

- ``mesh_ragged_stage_lanes`` stages the lanes once on the first slot's
  device and copies them once to every other distinct device (what the
  reference's all-gather of the lane messages delivers); slots sharing a
  device share the tensor.
- ``mesh_ragged_dispatch`` / ``mesh_ragged_collect`` launch one ragged
  update per non-empty slot and slice the accumulators back;
  ``ell_update_lanes_mesh_ragged`` chains the three, and
  ``ell_update_lanes_mesh_multi`` launches once per group and slot.
- ``ell_update_arrays`` is the global-index update of the distributed
  superstep: a plain gather, then the ``segment_combine`` kernel for sums.
  The combine's order (built from the data) and the kernel's wrapper are
  ``torch.library`` custom ops there, ``repro_torch::combine_order`` and
  ``repro_torch::segment_combine``, each with a fake implementation of
  its output shapes: the sharded dry run (``launch/dryrun.py``) reckons
  the superstep on tensors that hold no data, and sees the kernel's op.
  On real tensors they call the same functions (the kernel on the card).

The lane steps' ``backend`` is the executor's: ``"cuda"`` launches the
kernels, ``"torch"`` runs the plain tensor update.  They return the
accumulators with the count of accumulator slots that are not their
lane's identity (the reference's psum'd activity proxy).

On the card these launch the CUDA kernels; on CPU tensors the kernels'
plain versions run in their place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...core.csr import (DeviceEll, _combine_order, ragged_lane_concat,
                         ragged_lane_pad)
from . import kernel as K

__all__ = ["SENTINEL_PAD", "VARIANTS", "ell_update", "ell_update_batched",
           "extend_windows", "stage_messages", "stage_lanes",
           "ell_update_lanes", "ell_update_lanes_batched",
           "ell_update_lanes_multi", "ragged_stage_lanes", "ragged_dispatch",
           "ragged_collect", "ell_update_lanes_ragged", "split_rows",
           "mesh_stage_lanes", "mesh_ragged_stage_lanes",
           "mesh_ragged_dispatch", "mesh_ragged_collect",
           "ell_update_lanes_mesh_multi", "ell_update_lanes_mesh_ragged",
           "ell_update_arrays"]


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


#: identity slots appended to each window in the sentinel layout
SENTINEL_PAD = 8
VARIANTS = ("masked", "sentinel")


def extend_windows(msgs: torch.Tensor, window: int, combine: str) -> torch.Tensor:
    """The staged ``[num_windows * window]`` messages as the sentinel
    layout's ``[num_windows * (window + SENTINEL_PAD)]`` table: each window
    followed by ``SENTINEL_PAD`` slots of the combine's identity, on the
    same device."""
    if msgs.dim() != 1 or msgs.numel() % window:
        raise ValueError(f"{tuple(msgs.shape)} messages do not cover whole "
                         f"windows of {window}")
    ext = torch.full((msgs.numel() // window, window + SENTINEL_PAD),
                     K.IDENTITY[combine], dtype=msgs.dtype, device=msgs.device)
    ext[:, :window] = msgs.view(-1, window)
    return ext.view(-1)


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
                       combine: str, *, variant: str = "masked") -> torch.Tensor:
    """``acc[sum rows]``: the destination rows of every shard of ``ells``,
    in order; ``msgs`` is the staged ``[num_windows * window]`` message
    array on the same device.  Bitwise equal to one :func:`ell_update` per
    shard, concatenated, and the same for either ``variant``."""
    first = _check_batch(ells)
    tws = [e.tile_window for e in ells]
    if variant == "masked":
        part = K.ell_partials_masked([e.idx for e in ells],
                                     [e.mask for e in ells], tws, msgs,
                                     window=first.window, tr=first.tr,
                                     combine=combine)
    elif variant == "sentinel":
        part = K.ell_partials_sentinel(
            [e.sentinel_idx() for e in ells], tws,
            extend_windows(msgs, first.window, combine),
            window=first.window + SENTINEL_PAD, tr=first.tr, combine=combine)
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return K.segment_combine(part, [e.perm for e in ells],
                             [e.row_ptr for e in ells], combine)


def ell_update(ell: DeviceEll, msgs: torch.Tensor, combine: str, *,
               variant: str = "masked") -> torch.Tensor:
    """``acc[rows]`` for one device shard."""
    return ell_update_batched([ell], msgs, combine, variant=variant)


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


# ---------------------------------------------------------------------- mesh
def _mesh_fns(backend: str):
    """The executor's ragged and lane updates for ``backend`` (``torch``:
    plain tensor ops; ``cuda``: the kernels)."""
    from ...core import executor as X

    if backend not in X.RAGGED_BACKENDS:
        raise ValueError(f"mesh updates need an ELL backend, got {backend!r}; "
                         f"have {sorted(X.RAGGED_BACKENDS)}")
    return X.RAGGED_BACKENDS[backend], X.LANE_ELL_BACKENDS[backend]


def _distinct(devices) -> List[torch.device]:
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def _mesh_batches(device_ells, mesh):
    devices = mesh.device_list()
    if len(device_ells) != len(devices):
        raise ValueError(f"device_ells has {len(device_ells)} slots for a "
                         f"{len(devices)}-device mesh")
    out = {}
    for d, ells in enumerate(device_ells):
        if len(ells):
            first = _check_batch(ells)
            if first.device != devices[d]:
                raise ValueError(f"slot {d}'s shards are on {first.device}, "
                                 f"its device is {devices[d]}")
            out[d] = list(ells)
    return out


def _touched(acc: np.ndarray, ident: np.ndarray) -> int:
    """Accumulator slots of ``acc [L, rows]`` that differ from their lane's
    identity ``ident [L]`` (padding lanes: 0, which their zero rows hold)."""
    return int((acc != ident[:, None]).sum())


def mesh_stage_lanes(msgs: np.ndarray, n_pad_v: int, mesh) -> dict:
    """One group's ``[K_g, |V|]`` messages staged once on each distinct
    device of ``mesh`` (device -> :class:`~repro_torch.kernels.spmv_ell.
    kernel.LaneMessages`), the vertex axis padded to whole windows."""
    devs = _distinct(mesh.device_list())
    first = stage_lanes(msgs, n_pad_v, devs[0])
    return {dev: first if dev == devs[0] else K.LaneMessages(first.rows.to(dev))
            for dev in devs}


def mesh_ragged_stage_lanes(msgs_by_group, combines: Sequence[str],
                            n_pad_v: int, mesh) -> dict:
    """Mesh variant of :func:`ragged_stage_lanes`: the lane side staged on
    the first slot's device and copied once to each other distinct device
    (``by_device``).  The reference also pads the vertex axis to a multiple
    of the slot count, so that it shards evenly for its all-gather; here
    every device holds the whole matrix, so whole windows suffice."""
    devs = _distinct(mesh.device_list())
    ctx = ragged_stage_lanes(msgs_by_group, combines, n_pad_v, devs[0])
    by_device = {devs[0]: ctx}
    for dev in devs[1:]:
        by_device[dev] = dict(ctx, msgs=K.LaneMessages(ctx["msgs"].rows.to(dev)),
                              cids=ctx["cids"].to(dev))
    cids = ctx["cids"].cpu().numpy()
    ident = np.array([K.IDENTITY[ctx["combines"][c]]
                      if c < len(ctx["combines"]) else 0.0 for c in cids],
                     dtype=np.float32)
    return dict(ctx, by_device=by_device, ident=ident)


def mesh_ragged_dispatch(device_ells: Sequence[Sequence[DeviceEll]], lane_ctx,
                         *, mesh, backend: str = "cuda"):
    """Launch ONE ragged update on every slot that holds shards this round,
    each on its slot's device against that device's copy of the lanes.
    Returns a handle for :func:`mesh_ragged_collect` whose ``acc`` maps a
    slot to its ``[k_pad, rows]`` accumulator, left on the device so the
    caller can stage the next round while the launches run; ``None`` when
    every slot is empty."""
    ragged_fn, _ = _mesh_fns(backend)
    batches = _mesh_batches(device_ells, mesh)
    if not batches:
        return None
    devices = mesh.device_list()
    acc = {d: ragged_fn(ells, lane_ctx["by_device"][devices[d]])
           for d, ells in batches.items()}
    return {"batches": batches, "n_dev": len(devices), "acc": acc,
            "slices": lane_ctx["slices"], "ident": lane_ctx["ident"]}


def mesh_ragged_collect(handle):
    """A mesh ragged handle as ``(accs_by_group, touched)``:
    ``accs_by_group[g][d]`` lists slot ``d``'s per-shard ``[K_g, rows]``
    accumulators (empty for idle slots).  The handle's accumulators may be
    tensors (copied here, which waits for the launch) or host arrays."""
    accs = {d: a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            for d, a in handle["acc"].items()}
    batches = handle["batches"]
    touched = sum(_touched(a, handle["ident"]) for a in accs.values())
    accs_by_group = [
        [split_rows(batches[d], accs[d][sl]) if d in batches else []
         for d in range(handle["n_dev"])]
        for sl in handle["slices"]
    ]
    return accs_by_group, touched


def ell_update_lanes_mesh_ragged(device_ells, msgs_by_group, combines, *,
                                 mesh, backend: str = "cuda"):
    """Per-slot, per-shard ``[K_g, rows]`` accumulators for every group from
    ONE launch per non-empty slot; bitwise the multi path's per group.
    Returns ``(accs_by_group, touched)``."""
    if len(msgs_by_group) != len(combines):
        raise ValueError("one combine per message group")
    first = next((ells[0] for ells in device_ells if len(ells)), None)
    if first is None:
        return [[[] for _ in device_ells] for _ in msgs_by_group], 0
    ctx = mesh_ragged_stage_lanes(msgs_by_group, combines,
                                  first.num_windows * first.window, mesh)
    return mesh_ragged_collect(mesh_ragged_dispatch(device_ells, ctx, mesh=mesh,
                                                    backend=backend))


def ell_update_lanes_mesh_multi(device_ells, msgs_by_group, combines, *,
                                mesh, backend: str = "cuda"):
    """The mesh's per-group dispatch: for each group, one lane update on
    every slot that holds shards.  A group's messages are a ``[K_g, |V|]``
    array or the device map :func:`mesh_stage_lanes` made of it.  Returns
    ``(accs_by_group, touched_by_group)``; ``accs_by_group[g][d]`` lists
    slot ``d``'s per-shard accumulators (empty for idle slots)."""
    if len(msgs_by_group) != len(combines):
        raise ValueError("one combine per message group")
    _, lane_fn = _mesh_fns(backend)
    batches = _mesh_batches(device_ells, mesh)
    n_dev = len(device_ells)
    if not batches:
        return [[[] for _ in device_ells] for _ in msgs_by_group], \
            [0] * len(msgs_by_group)
    first = next(iter(batches.values()))[0]
    devices = mesh.device_list()
    accs_by_group, touched_by_group = [], []
    for msgs, combine in zip(msgs_by_group, combines):
        if not isinstance(msgs, dict):
            msgs = mesh_stage_lanes(msgs, first.num_windows * first.window,
                                    mesh)
        accs = {d: lane_fn(ells, msgs[devices[d]], combine).cpu().numpy()
                for d, ells in batches.items()}
        ident = np.full(next(iter(accs.values())).shape[0],
                        K.IDENTITY[combine], dtype=np.float32)
        touched_by_group.append(sum(_touched(a, ident) for a in accs.values()))
        accs_by_group.append([split_rows(batches[d], accs[d]) if d in accs
                              else [] for d in range(n_dev)])
    return accs_by_group, touched_by_group


def ell_update_arrays(idx_global: torch.Tensor, valid, seg: torch.Tensor,
                      msgs: torch.Tensor, rows: int, combine: str
                      ) -> torch.Tensor:
    """Global-index update (the distributed superstep): ``acc[rows]`` from
    ELL rows of global source ids against the whole message array.

    The gather is plain tensor ops, as the reference's is XLA.  Sums fold
    each ELL row, then the rows through the ``segment_combine`` kernel (its
    plain version on CPU tensors): a fixed order, no atomics.  Min and max
    fold through ``scatter_reduce``, which no order changes.  ``valid=None``
    is the sentinel layout: padding slots index past the end of ``msgs``,
    and one identity slot there answers them."""
    ident = K.IDENTITY[combine]
    gidx = idx_global.to(torch.int64)
    if valid is None:
        valid = gidx < msgs.numel()
        g = torch.cat([msgs, msgs.new_full((1,), ident)])[gidx]
    else:
        g = torch.where(valid, msgs[gidx.clamp(0, msgs.numel() - 1)], ident)
    if combine == "sum":
        perm, row_ptr = combine_order_op(valid, seg, rows)
        return segment_combine_op(g.sum(dim=1), perm, row_ptr, "sum")
    part = g.amin(dim=1) if combine == "min" else g.amax(dim=1)
    acc = torch.full((rows,), ident, dtype=msgs.dtype, device=msgs.device)
    return acc.scatter_reduce_(0, seg.to(torch.int64), part,
                               reduce="amin" if combine == "min" else "amax")


@torch.library.custom_op("repro_torch::combine_order", mutates_args=())
def combine_order_op(mask: torch.Tensor, seg: torch.Tensor,
                     rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``core.csr._combine_order`` as an op: ``(perm [n_ell], row_ptr
    [rows + 1])``, both int32."""
    return _combine_order(mask, seg, rows)


@combine_order_op.register_fake
def _(mask, seg, rows):
    return (seg.new_empty(seg.shape, dtype=torch.int32),
            seg.new_empty((rows + 1,), dtype=torch.int32))


@torch.library.custom_op("repro_torch::segment_combine", mutates_args=())
def segment_combine_op(part: torch.Tensor, perm: torch.Tensor,
                       row_ptr: torch.Tensor, combine: str) -> torch.Tensor:
    """One shard's ``kernel.segment_combine`` as an op (the kernel, and its
    launch count, on the card)."""
    return K.segment_combine(part, perm, row_ptr, combine)


@segment_combine_op.register_fake
def _(part, perm, row_ptr, combine):
    return part.new_empty((row_ptr.shape[0] - 1,), dtype=torch.float32)
