"""Public entry points of batched Bloom membership: the shard-activity test.

``any_active_shards`` evaluates the paper's skip decision (§II-D-1) for
EVERY shard in one call: given the per-shard ``BloomFilter32``s and the
active-vertex ids, a bool per shard.  On the card all filters go through
one launch (up to :data:`~.kernel.MAX_FILTERS`) that reduces each
filter's bits to one flag there, where the reference launches once per
filter and brings every filter's ``[n]`` bits back.  ``contains`` is the
membership bits of one filter.

Both take and return numpy, as the reference does, and run on the card
unless the caller passes ``device="cpu"`` (then the kernel's plain
version runs).  ``stage_filters`` copies filters' tables to a device, as
the kernel wrapper takes them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ...core.bloom import BloomFilter32
from ...core.executor import resolve_device
from .kernel import bloom_contains

__all__ = ["DeviceFilters", "any_active_shards", "contains", "pad_items",
           "stage_filters"]

_TILE = 1024


def pad_items(items: np.ndarray, pad_value: int = -1) -> np.ndarray:
    """``items`` as int32 padded with ``pad_value`` to a multiple of 1024
    (at least one tile): the TPU kernel's tiling.  The port's kernel takes
    any count; this is kept for callers that batch in tiles."""
    n = len(items)
    out = np.full(-(-max(n, 1) // _TILE) * _TILE, pad_value, dtype=np.int32)
    out[:n] = items
    return out


@dataclasses.dataclass
class DeviceFilters:
    """Bloom filters' word tables on one device, in shard order."""

    words: List[torch.Tensor]  # uint32 [num_bits // 32] each
    num_bits: List[int]
    num_hashes: List[int]


def stage_filters(filters: Sequence[BloomFilter32], device="cuda") -> DeviceFilters:
    """Copy each filter's word table to ``device``."""
    dev = resolve_device(device)
    if not filters:
        raise ValueError("no filters")
    return DeviceFilters(
        words=[torch.from_numpy(np.ascontiguousarray(f.words, np.uint32)).to(dev)
               for f in filters],
        num_bits=[int(f.num_bits) for f in filters],
        num_hashes=[int(f.num_hashes) for f in filters])


def _ids(items: np.ndarray, device: torch.device) -> torch.Tensor:
    ids = np.ascontiguousarray(np.asarray(items).astype(np.int32, copy=False))
    return torch.from_numpy(ids).to(device)


def contains(f: BloomFilter32, items: np.ndarray, *, device="cuda") -> np.ndarray:
    """Membership bits of an arbitrary-length id array, bool ``[n]``."""
    if len(items) == 0:
        return np.zeros(0, dtype=bool)
    dev = resolve_device(device)
    staged = stage_filters([f], dev)
    out = bloom_contains(staged.words[0], _ids(items, dev),
                         num_bits=staged.num_bits[0],
                         num_hashes=staged.num_hashes[0])
    return out.cpu().numpy()


def any_active_shards(filters: Sequence[BloomFilter32], active_ids: np.ndarray,
                      *, device="cuda") -> np.ndarray:
    """bool ``[num_shards]``: shard p has (possibly) >= 1 active source.

    An empty active set activates no shard.  No id is padded, so no
    padding id can ever activate a shard.
    """
    if len(active_ids) == 0:
        return np.zeros(len(filters), dtype=bool)
    dev = resolve_device(device)
    staged = stage_filters(filters, dev)
    out = bloom_contains(staged.words, _ids(active_ids, dev),
                         num_bits=staged.num_bits,
                         num_hashes=staged.num_hashes, reduce_any=True)
    return out.cpu().numpy()
