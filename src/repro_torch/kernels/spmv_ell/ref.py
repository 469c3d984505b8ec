"""Plain torch oracle of the windowed row-split ELL pull-update.

The mathematical contract of the VSW hot loop with the reference's
signature (``seg`` per ELL row, not the port's combine order): given
per-source messages and a shard in windowed ELL form, the combined in-edge
accumulation per destination row.  Empty rows get the combine identity.
"""

from __future__ import annotations

import torch

from .kernel import ell_partials_masked_plain, segment_combine_plain

__all__ = ["ell_update_ref", "partials_ref"]


def partials_ref(ell_idx, ell_valid, tile_window, msgs, *, window: int,
                 tr: int, combine: str) -> torch.Tensor:
    """Just the per-ELL-row partial reduction (what the kernel computes)."""
    return ell_partials_masked_plain(ell_idx, ell_valid, tile_window, msgs,
                                     window=window, tr=tr, combine=combine)


def ell_update_ref(ell_idx, ell_valid, seg, tile_window, msgs, *, window: int,
                   tr: int, rows: int, combine: str) -> torch.Tensor:
    """``acc[rows]`` = COMBINE over valid slots of ``msgs[global_idx]``."""
    part = partials_ref(ell_idx, ell_valid, tile_window, msgs, window=window,
                        tr=tr, combine=combine)
    sorted_seg, perm = torch.sort(seg.to(torch.int64), stable=True)
    bounds = torch.arange(rows + 1, device=seg.device)
    row_ptr = torch.searchsorted(sorted_seg, bounds, out_int32=True)
    return segment_combine_plain(part, perm.to(torch.int32), row_ptr, combine)
