"""Public entry points of the ELL pull-update: the ``cuda`` backend.

``ell_update_batched`` runs N consecutive planned shards (DESIGN.md §4)
through ONE launch of the partials kernel and one of the segment combine,
each reading every shard's own device tensors, and returns the
destination rows of all N in shard order; the executor runs every
dispatch through it.  ``ell_update`` is the same for one shard.
``stage_messages`` copies an iteration's message array to the device once,
padded to whole windows.

On the card these launch the CUDA kernels; on CPU tensors the kernels'
plain versions run in their place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...core.csr import DeviceEll
from . import kernel as K

__all__ = ["ell_update", "ell_update_batched", "stage_messages"]


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


def ell_update_batched(ells: Sequence[DeviceEll], msgs: torch.Tensor,
                       combine: str) -> torch.Tensor:
    """``acc[sum rows]``: the destination rows of every shard of ``ells``,
    in order; ``msgs`` is the staged ``[num_windows * window]`` message
    array on the same device.  Bitwise equal to one :func:`ell_update` per
    shard, concatenated."""
    if not ells:
        raise ValueError("empty ELL batch")
    first = ells[0]
    for e in ells[1:]:
        if (e.window, e.k, e.tr, e.num_vertices) != (
                first.window, first.k, first.tr, first.num_vertices):
            raise ValueError("ELL shards in a batch must share window/k/tr/|V|")
    part = K.ell_partials_masked([e.idx for e in ells], [e.mask for e in ells],
                                 [e.tile_window for e in ells], msgs,
                                 window=first.window, tr=first.tr,
                                 combine=combine)
    return K.segment_combine(part, [e.perm for e in ells],
                             [e.row_ptr for e in ells], combine)


def ell_update(ell: DeviceEll, msgs: torch.Tensor, combine: str) -> torch.Tensor:
    """``acc[rows]`` for one device shard."""
    return ell_update_batched([ell], msgs, combine)
