"""CSR -> windowed row-split ELL: the shard format the device kernels read.

The store keeps each shard twice: the paper's CSR, and a *windowed,
row-split ELL* re-blocking of it that the update kernels stream row by row.
The on-disk layout is the reference package's, byte for byte.

- **Source windows**: edges are grouped by ``window = src // W``, so an
  ELL row gathers from one ``W``-wide slice of the message array.  With
  ``W <= 2**15`` the column indices fit ``int16`` (half the index bytes).
- **Row splitting**: a destination with in-degree ``d`` inside one window
  becomes ``ceil(d / K)`` ELL rows of width ``K``; a ``seg`` array maps each
  ELL row back to its local destination row.  Partial reductions per ELL row
  are segment-combined afterwards (sum/min/max), which keeps rows dense
  regardless of degree skew.
- **Tiling**: ELL rows are padded per window to a multiple of ``TR`` so a
  ``(TR, K)`` tile never straddles two source windows; ``tile_window[t]``
  names the window of tile ``t``.

Padding rows carry ``valid=False`` masks and ``seg=0``; they contribute the
combine identity and are therefore harmless.

:class:`DeviceEll` is the same shard on a torch device, plus a stable
``seg`` order (``perm``/``row_ptr``) so the segment combine reduces every
destination row in a fixed order without atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .sharding import ShardCSR

__all__ = [
    "EllShard",
    "EllBatch",
    "csr_to_ell",
    "concat_ells",
    "DeviceEll",
    "ell_to_device",
    "next_pow2",
    "ragged_lane_pad",
    "ragged_lane_concat",
    "DEFAULT_K",
    "DEFAULT_TR",
    "DEFAULT_WINDOW",
]


DEFAULT_K = 128  # ELL width
DEFAULT_TR = 8  # tile rows
DEFAULT_WINDOW = 1 << 14  # 16384 source vertices per window (64KB fp32 table)


def next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


@dataclasses.dataclass
class EllShard:
    """Windowed row-split ELL representation of one destination shard."""

    shard_id: int
    v0: int
    v1: int
    num_vertices: int  # of the whole graph (defines window count)
    window: int  # W
    k: int  # ELL width
    tr: int  # tile rows
    ell_idx: np.ndarray  # int16/int32 [n_ell, K] window-local source indices
    ell_mask: np.ndarray  # bool  [n_ell, K]
    seg: np.ndarray  # int32 [n_ell] local destination row (0 for padding)
    tile_window: np.ndarray  # int32 [n_ell // TR] source-window id per tile
    nnz: int

    @property
    def rows(self) -> int:
        return self.v1 - self.v0

    @property
    def n_ell(self) -> int:
        return int(self.ell_idx.shape[0])

    @property
    def n_tiles(self) -> int:
        return int(self.tile_window.shape[0])

    @property
    def num_windows(self) -> int:
        return max(1, -(-self.num_vertices // self.window))

    @property
    def nbytes(self) -> int:
        return int(
            self.ell_idx.nbytes
            + self.ell_mask.nbytes
            + self.seg.nbytes
            + self.tile_window.nbytes
        )

    def global_idx(self) -> np.ndarray:
        """Recover global source ids, [n_ell, K] (undefined where mask=False)."""
        win = np.repeat(self.tile_window, self.tr).astype(np.int64)
        return self.ell_idx.astype(np.int64) + win[:, None] * self.window

    def padding_ratio(self) -> float:
        """Fraction of ELL slots that are padding (wasted bandwidth)."""
        total = self.ell_idx.size
        return 1.0 - (self.nnz / total) if total else 0.0


@dataclasses.dataclass
class EllBatch:
    """N consecutive ELL shards concatenated into one kernel dispatch.

    All constituent shards share ``window``/``k``/``tr``/``num_vertices``
    (one preprocessing run), so their tile->window prefetch maps live in the
    same coordinate system and simply concatenate: one kernel launch walks
    every tile of every shard against ONE message array, amortizing
    per-shard dispatch overhead (DESIGN.md §4).

    ``seg`` is globalized (shard-local destination row + the shard's row
    offset) so one segment combine with ``rows_total`` segments covers the
    whole batch; ``row_offsets`` splits the combined accumulator back into
    per-shard intervals.
    """

    shard_ids: list
    ell_idx: np.ndarray  # [sum n_ell, K]
    ell_mask: np.ndarray  # bool [sum n_ell, K]
    seg: np.ndarray  # int32 [sum n_ell] globalized destination rows
    tile_window: np.ndarray  # int32 [sum n_tiles]
    row_offsets: np.ndarray  # int64 [N+1] shard row boundaries in the acc
    num_vertices: int
    window: int
    k: int
    tr: int

    @property
    def rows_total(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def n_ell(self) -> int:
        return int(self.ell_idx.shape[0])

    @property
    def num_windows(self) -> int:
        return max(1, -(-self.num_vertices // self.window))

    def split(self, acc: np.ndarray) -> list:
        """Slice a combined accumulator (rows on the trailing axis) back
        per shard."""
        return [
            acc[..., self.row_offsets[i]: self.row_offsets[i + 1]]
            for i in range(len(self.shard_ids))
        ]


def concat_ells(ells: Sequence[EllShard]) -> EllBatch:
    """Concatenate ELL shards for one batched dispatch.

    Requires a homogeneous batch (same window/k/tr/num_vertices — true for
    any shards from one store) and tile-aligned shards (``n_ell % tr == 0``,
    guaranteed by :func:`csr_to_ell`'s per-window padding).
    """
    if not ells:
        raise ValueError("empty ELL batch")
    first = ells[0]
    for e in ells[1:]:
        if (e.window, e.k, e.tr, e.num_vertices) != (
            first.window, first.k, first.tr, first.num_vertices
        ):
            raise ValueError("ELL shards in a batch must share window/k/tr/|V|")
    for e in ells:
        if e.n_ell % e.tr:
            raise ValueError(f"shard {e.shard_id}: n_ell not tile-aligned")
    row_offsets = np.zeros(len(ells) + 1, dtype=np.int64)
    np.cumsum([e.rows for e in ells], out=row_offsets[1:])
    seg = np.concatenate(
        [e.seg.astype(np.int32) + np.int32(off)
         for e, off in zip(ells, row_offsets[:-1])]
    )
    return EllBatch(
        shard_ids=[e.shard_id for e in ells],
        ell_idx=np.concatenate([e.ell_idx for e in ells]),
        ell_mask=np.concatenate([e.ell_mask for e in ells]),
        seg=seg,
        tile_window=np.concatenate([e.tile_window for e in ells]),
        row_offsets=row_offsets,
        num_vertices=first.num_vertices,
        window=first.window,
        k=first.k,
        tr=first.tr,
    )


def ragged_lane_pad(lane_counts: Sequence[int]) -> int:
    """Padded lane count for ONE ragged launch covering all fusion groups.

    The multi-launch path pads every group to its own power of two, so its
    total waste is ``sum(next_pow2(k_g)) - sum(k_g)``.  One ragged launch
    pads the concatenated count to ``next_pow2(K_total)``, capped at the
    per-group pow2 total, so its waste is never worse than the G-launch
    waste (counts ``1,1,1`` give 3, not 4).
    """
    k_total = int(sum(int(k) for k in lane_counts))
    per_group = int(sum(next_pow2(max(int(k), 1)) for k in lane_counts))
    return max(1, min(next_pow2(max(k_total, 1)), per_group))


def ragged_lane_concat(msgs_by_group, combines: Sequence[str], *,
                       n_cols: Optional[int] = None,
                       out: Optional[np.ndarray] = None):
    """Concatenate per-group lane matrices along the lane axis for one
    ragged launch.

    Returns ``(msgs_all, combine_ids, combines_set, group_slices)``:

    - ``msgs_all``   [k_pad, n_cols] — groups stacked then zero-padded to
      :func:`ragged_lane_pad` lanes (and to ``n_cols`` columns, the
      window-padded vertex count).  ``out``, when given, is that array,
      preallocated by the caller (a pinned staging buffer).
    - ``combine_ids`` int32 [k_pad] — per lane, the index of its combine op
      in ``combines_set``.  Padding lanes get ``len(combines_set)``, an id
      that matches no arm.
    - ``combines_set`` — deduplicated combine ops in first-seen order (two
      groups sharing a monoid share one kernel arm).
    - ``group_slices`` — per input group, its lane interval in ``msgs_all``.
    """
    if len(msgs_by_group) != len(combines):
        raise ValueError("one combine op per group required")
    if not msgs_by_group:
        raise ValueError("empty ragged lane concat")
    combines_set = tuple(dict.fromkeys(combines))
    counts = [int(m.shape[0]) for m in msgs_by_group]
    k_pad = ragged_lane_pad(counts)
    n = int(msgs_by_group[0].shape[1] if n_cols is None else n_cols)
    if out is None:
        msgs_all = np.zeros((k_pad, n), dtype=msgs_by_group[0].dtype)
    else:
        if out.shape != (k_pad, n):
            raise ValueError(f"out has shape {out.shape}, need {(k_pad, n)}")
        msgs_all = out
    combine_ids = np.full(k_pad, len(combines_set), dtype=np.int32)
    group_slices = []
    off = 0
    for m, c in zip(msgs_by_group, combines):
        if m.shape[1] > n:
            raise ValueError("group lane matrix wider than n_cols")
        sl = slice(off, off + int(m.shape[0]))
        msgs_all[sl, : m.shape[1]] = m
        msgs_all[sl, m.shape[1]:] = 0
        combine_ids[sl] = combines_set.index(c)
        group_slices.append(sl)
        off = sl.stop
    msgs_all[off:] = 0
    return msgs_all, combine_ids, combines_set, group_slices


def csr_to_ell(
    shard: ShardCSR,
    num_vertices: int,
    *,
    window: int = DEFAULT_WINDOW,
    k: int = DEFAULT_K,
    tr: int = DEFAULT_TR,
    index_dtype: Optional[np.dtype] = None,
) -> EllShard:
    """Convert a CSR destination shard into the windowed row-split ELL format."""
    if window <= 0 or k <= 0 or tr <= 0:
        raise ValueError("window, k, tr must be positive")
    if index_dtype is None:
        index_dtype = np.int16 if window <= (1 << 15) else np.int32

    rows = shard.rows
    nnz = shard.nnz

    if nnz == 0:
        ell_idx = np.zeros((tr, k), dtype=index_dtype)
        ell_mask = np.zeros((tr, k), dtype=bool)
        seg = np.zeros((tr,), dtype=np.int32)
        tile_window = np.zeros((1,), dtype=np.int32)
        return EllShard(
            shard.shard_id, shard.v0, shard.v1, num_vertices, window, k, tr,
            ell_idx, ell_mask, seg, tile_window, nnz=0,
        )

    # Expand CSR to (local_dst, src) pairs, then sort by (window, local_dst, src).
    counts = np.diff(shard.row)
    local_dst = np.repeat(np.arange(rows, dtype=np.int64), counts)
    src = shard.col.astype(np.int64)
    win = src // window
    order = np.lexsort((src, local_dst, win))
    src, local_dst, win = src[order], local_dst[order], win[order]
    local_src = (src - win * window).astype(np.int64)

    # Row splitting: within each (window, local_dst) group, edge j goes to ELL
    # row group_start_ell + j // K, slot j % K.
    grp_change = np.empty(nnz, dtype=bool)
    grp_change[0] = True
    grp_change[1:] = (win[1:] != win[:-1]) | (local_dst[1:] != local_dst[:-1])
    grp_id = np.cumsum(grp_change) - 1  # [nnz]
    grp_start = np.flatnonzero(grp_change)  # first edge index of each group
    pos_in_grp = np.arange(nnz, dtype=np.int64) - grp_start[grp_id]
    rows_per_grp = np.ceil(
        np.diff(np.concatenate([grp_start, [nnz]])) / k
    ).astype(np.int64)

    # ELL row index before per-window tile padding.
    grp_row_start = np.concatenate([[0], np.cumsum(rows_per_grp)])[:-1]
    raw_ell_row = grp_row_start[grp_id] + pos_in_grp // k
    slot = pos_in_grp % k
    n_raw = int(rows_per_grp.sum())

    raw_seg = np.zeros(n_raw, dtype=np.int32)
    raw_win = np.zeros(n_raw, dtype=np.int64)
    raw_seg[grp_row_start] = 0  # filled below via scatter of group attrs
    # Each raw ELL row inherits (window, local_dst) of its group.
    grp_first_edge = grp_start  # [n_groups]
    grp_window = win[grp_first_edge]
    grp_dst = local_dst[grp_first_edge]
    row_grp = np.repeat(np.arange(len(grp_start)), rows_per_grp)
    raw_seg = grp_dst[row_grp].astype(np.int32)
    raw_win = grp_window[row_grp]

    # Pad ELL rows per window to a multiple of TR so tiles are window-pure.
    uniq_wins, win_row_counts = np.unique(raw_win, return_counts=True)
    padded_counts = -(-win_row_counts // tr) * tr
    win_row_offset = np.concatenate([[0], np.cumsum(padded_counts)])[:-1]
    n_ell = int(padded_counts.sum())

    # Map raw rows -> padded positions.
    win_rank = np.searchsorted(uniq_wins, raw_win)
    # position of raw row within its window block:
    row_in_win = np.zeros(n_raw, dtype=np.int64)
    # raw rows are already sorted by window (construction preserves sort order)
    start_of_win = np.concatenate([[0], np.cumsum(win_row_counts)])[:-1]
    row_in_win = np.arange(n_raw) - start_of_win[win_rank]
    padded_row = win_row_offset[win_rank] + row_in_win

    ell_idx = np.zeros((n_ell, k), dtype=index_dtype)
    ell_mask = np.zeros((n_ell, k), dtype=bool)
    seg = np.zeros((n_ell,), dtype=np.int32)
    seg[padded_row] = raw_seg

    # Scatter edges into the padded ELL arrays.
    edge_rows = padded_row[raw_ell_row]
    ell_idx[edge_rows, slot] = local_src.astype(index_dtype)
    ell_mask[edge_rows, slot] = True

    n_tiles = n_ell // tr
    tile_window = np.repeat(uniq_wins, padded_counts // tr).astype(np.int32)
    assert tile_window.shape[0] == n_tiles

    out = EllShard(
        shard.shard_id, shard.v0, shard.v1, num_vertices, window, k, tr,
        ell_idx, ell_mask, seg, tile_window, nnz=nnz,
    )
    assert int(out.ell_mask.sum()) == nnz
    return out


# --------------------------------------------------------------------------
# Device side
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceEll:
    """One ELL shard on a device.

    ``idx``/``mask``/``tile_window`` are the store's arrays as tensors.
    ``perm``/``row_ptr`` give the segment combine its order: destination
    row ``r`` reduces the partials of ELL rows
    ``perm[row_ptr[r]:row_ptr[r + 1]]``, which ascend.  Rows whose mask is
    all False (per-window tile padding) are left out of that order: they
    would only add the combine identity to row 0.  A batch of shards is a
    sequence of these; the kernels read each shard's own tensors.
    """

    shard_id: int
    v0: int
    v1: int
    num_vertices: int
    window: int
    k: int
    tr: int
    nnz: int
    idx: torch.Tensor  # int16/int32 [n_ell, K] window-local source indices
    mask: torch.Tensor  # bool [n_ell, K]
    tile_window: torch.Tensor  # int32 [n_ell // tr]
    perm: torch.Tensor  # int32 [n_ell]; the first row_ptr[-1] entries are used
    row_ptr: torch.Tensor  # int32 [rows + 1]
    _sentinel_idx: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def rows(self) -> int:
        return self.v1 - self.v0

    @property
    def n_ell(self) -> int:
        return int(self.idx.shape[0])

    @property
    def num_windows(self) -> int:
        return max(1, -(-self.num_vertices // self.window))

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def sentinel_idx(self) -> torch.Tensor:
        """The index plane of the sentinel layout: ``idx`` with every
        padding slot pointing at column ``window``, the first identity slot
        past its window.  int16 while ``window`` fits it, else int32.
        Built on the shard's device at first use and kept."""
        if self._sentinel_idx is None:
            dtype = torch.int16 if self.window <= 32767 else torch.int32
            self._sentinel_idx = torch.where(
                self.mask, self.idx.to(dtype),
                torch.tensor(self.window, dtype=dtype, device=self.device))
        return self._sentinel_idx

    def padding_ratio(self) -> float:
        """Fraction of ELL slots that are padding."""
        total = self.idx.numel()
        return 1.0 - (self.nnz / total) if total else 0.0


def _combine_order(mask: torch.Tensor, seg: torch.Tensor, rows: int):
    """Stable ``seg`` order of the non-padding ELL rows, as ``(perm,
    row_ptr)``.  Padding rows get the key ``rows`` and sort past the end."""
    key = torch.where(mask.any(dim=1), seg.to(torch.int64),
                      torch.full_like(seg, rows, dtype=torch.int64))
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(rows + 1, device=seg.device, dtype=torch.int64)
    row_ptr = torch.searchsorted(sorted_key, bounds, out_int32=True)
    return perm.to(torch.int32), row_ptr


def ell_to_device(ell: EllShard, device) -> DeviceEll:
    """Move a decoded host :class:`EllShard` (this package's or the
    reference's: only its numpy fields are read) to ``device`` and build
    its combine order there."""
    nw = max(1, -(-ell.num_vertices // ell.window))
    tw = np.ascontiguousarray(ell.tile_window, dtype=np.int32)
    if tw.size and (int(tw.min()) < 0 or int(tw.max()) >= nw):
        raise ValueError(f"shard {ell.shard_id}: tile_window outside "
                         f"[0, {nw})")
    if ell.ell_idx.shape[0] != tw.shape[0] * ell.tr:
        raise ValueError(f"shard {ell.shard_id}: n_ell != n_tiles * tr")
    device = torch.device(device)
    idx = torch.from_numpy(np.ascontiguousarray(ell.ell_idx)).to(device)
    mask = torch.from_numpy(np.ascontiguousarray(ell.ell_mask, dtype=bool))
    mask = mask.to(device)
    seg = torch.from_numpy(np.ascontiguousarray(ell.seg, dtype=np.int32))
    perm, row_ptr = _combine_order(mask, seg.to(device), int(ell.v1 - ell.v0))
    return DeviceEll(
        shard_id=int(ell.shard_id), v0=int(ell.v0), v1=int(ell.v1),
        num_vertices=int(ell.num_vertices), window=int(ell.window),
        k=int(ell.k), tr=int(ell.tr), nnz=int(ell.nnz), idx=idx, mask=mask,
        tile_window=torch.from_numpy(tw).to(device), perm=perm,
        row_ptr=row_ptr,
    )
