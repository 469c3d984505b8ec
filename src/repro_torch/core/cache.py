"""Compressed edge cache (paper §II-D-2).

The VSW model leaves most of a server's memory idle (vertices + the shards
under processing are small), so GraphMP fills it with an in-application
shard cache.  A cache hit skips the disk read entirely; to raise the hit
rate the cached bytes may be compressed, trading decompression CPU for
eliminated I/O.  The paper's four modes:

=======  ==================  =============================================
mode     paper codec         this implementation (snappy is unavailable
                             offline; zlib-1 plays its fast/low-ratio role)
=======  ==================  =============================================
mode-1   uncompressed        raw shard bytes
mode-2   snappy              zlib level 1
mode-3   zlib-1              zlib level 3
mode-4   zlib-3              zlib level 6
=======  ==================  =============================================

Two admission policies share one byte budget.  ``"lru"`` (the default,
the reference's) admits every miss and evicts the least recently used
entries to make room.  ``"keep"`` admits a miss only where it fits in
the room left, and evicts nothing: the paper keeps a fixed subset of the
shards, so a scan in the same order every iteration (PageRank plans
every shard) hits on the cached share of a store larger than the budget,
where LRU would evict each shard before the scan came back to it.  An
``invalidate`` frees room under either policy, and the next miss may fill
it.  The cache stores the *container
bytes* (what would have been read from disk), so hit/miss accounting lines
up exactly with the I/O model's ``θ·D·|E|`` term: ``θ`` is literally
``misses / lookups`` weighted by shard size.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Optional

from ..obs import trace

__all__ = ["CacheMode", "CacheStats", "ShardCache", "MODES", "POLICIES",
           "mode_iteration_cost", "select_cache_mode"]


@dataclasses.dataclass(frozen=True)
class CacheMode:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


MODES: Dict[int, CacheMode] = {
    1: CacheMode("raw", lambda b: b, lambda b: b),
    2: CacheMode("fast(zlib-1)", lambda b: zlib.compress(b, 1), zlib.decompress),
    3: CacheMode("zlib-3", lambda b: zlib.compress(b, 3), zlib.decompress),
    4: CacheMode("zlib-6", lambda b: zlib.compress(b, 6), zlib.decompress),
}

#: admission policies (module docstring)
POLICIES = ("lru", "keep")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserted_bytes_raw: int = 0
    inserted_bytes_stored: int = 0
    compress_time_s: float = 0.0
    decompress_time_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def compression_ratio(self) -> float:
        if self.inserted_bytes_stored == 0:
            return 1.0
        return self.inserted_bytes_raw / self.inserted_bytes_stored

    def reset_counters(self) -> None:
        """Zero every running counter (hit/miss, evictions, codec timers) —
        capacity-state fields (`inserted_bytes_*`) describe what is IN the
        cache and are deliberately kept."""
        self.hits = self.misses = self.evictions = 0
        self.compress_time_s = self.decompress_time_s = 0.0


class ShardCache:
    """Byte-budgeted cache of (optionally compressed) shard container
    bytes, under the ``"lru"`` or ``"keep"`` policy (module docstring).

    Thread-safe: the prefetching loader (``repro_torch.core.pipeline``) calls
    ``get``/``put`` from background threads, so the LRU book-keeping and the
    stats counters are guarded by one lock.  Compression/decompression run
    outside the lock — they are the expensive part and operate on local data.
    """

    def __init__(self, capacity_bytes: int, mode: int = 1,
                 policy: str = "lru"):
        if mode not in MODES:
            raise ValueError(f"unknown cache mode {mode}; valid: {sorted(MODES)}")
        if policy not in POLICIES:
            raise ValueError(f"unknown cache policy {policy!r}; valid: "
                             f"{list(POLICIES)}")
        self.capacity_bytes = capacity_bytes
        self.mode = MODES[mode]
        self.mode_id = mode
        self.policy = policy
        self.stats = CacheStats()
        self._data: "OrderedDict[int, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def keys(self):
        """Snapshot of cached shard ids in LRU -> MRU order."""
        with self._lock:
            return list(self._data.keys())

    @property
    def stored_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, shard_id: int) -> Optional[bytes]:
        """Return the *raw* (decompressed) shard bytes, or None on miss."""
        with trace.span("cache.get", shard=shard_id) as sp:
            with self._lock:
                blob = self._data.get(shard_id)
                if blob is None:
                    self.stats.misses += 1
                    sp.set(hit=False)
                    return None
                self._data.move_to_end(shard_id)
                self.stats.hits += 1
            sp.set(hit=True)
            t0 = time.perf_counter()
            raw = self.mode.decompress(blob)
            with self._lock:
                self.stats.decompress_time_s += time.perf_counter() - t0
            return raw

    def put(self, shard_id: int, raw: bytes) -> bool:
        """Insert if it fits; returns True if cached."""
        with trace.span("cache.put", shard=shard_id, bytes=len(raw)):
            return self._put(shard_id, raw)

    def _put(self, shard_id: int, raw: bytes) -> bool:
        with self._lock:
            if shard_id in self._data:
                # Re-put counts as a touch: refresh recency or the entry
                # ages as if never used and gets evicted first.
                self._data.move_to_end(shard_id)
                return True
        t0 = time.perf_counter()
        blob = self.mode.compress(raw)
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats.compress_time_s += dt
            if len(blob) > self.capacity_bytes:
                return False
            if shard_id in self._data:  # raced with another loader thread
                self._data.move_to_end(shard_id)
                return True
            if (self.policy == "keep"
                    and self._bytes + len(blob) > self.capacity_bytes):
                return False
            while self._bytes + len(blob) > self.capacity_bytes and self._data:
                _, old = self._data.popitem(last=False)
                self._bytes -= len(old)
                self.stats.evictions += 1
            self._data[shard_id] = blob
            self._bytes += len(blob)
            self.stats.inserted_bytes_raw += len(raw)
            self.stats.inserted_bytes_stored += len(blob)
            return True

    def invalidate(self, shard_id: int) -> bool:
        """Drop one entry (the shard was overwritten on disk); returns
        whether anything was cached.  Not counted as an eviction — the
        entry did not lose a capacity race, it became wrong."""
        with self._lock:
            blob = self._data.pop(shard_id, None)
            if blob is None:
                return False
            self._bytes -= len(blob)
            return True

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0


def mode_iteration_cost(
    ratio: float,
    comp_s_per_byte: float,
    dec_s_per_byte: float,
    capacity_bytes: int,
    total_raw_bytes: int,
    *,
    disk_bw: float = 150e6,
    lifetime_iters: int = 10,
) -> float:
    """Estimated per-iteration cost of caching under one compression mode.

    Three terms: (1) disk time for the bytes that still miss, (2)
    decompression of the cached fraction on every iteration, (3) the
    ONE-TIME compression of the cached fraction, amortized over the
    cache's expected lifetime of ``lifetime_iters`` iterations — entries
    are compressed once at insert and then hit repeatedly, so charging the
    full compression time per iteration would overstate it by the
    lifetime, and dropping it (the pre-fix behavior) understates slow
    codecs whose compression cost is real.
    """
    stored_total = total_raw_bytes / max(ratio, 1e-12)
    cached_frac = min(1.0, capacity_bytes / max(stored_total, 1))
    miss_bytes = (1.0 - cached_frac) * total_raw_bytes
    cached_raw = cached_frac * total_raw_bytes
    return (
        miss_bytes / disk_bw
        + cached_raw * dec_s_per_byte
        + cached_raw * comp_s_per_byte / max(lifetime_iters, 1)
    )


def select_cache_mode(
    sample_raw: bytes,
    capacity_bytes: int,
    total_raw_bytes: int,
    *,
    disk_bw: float = 150e6,
    lifetime_iters: int = 10,
) -> int:
    """Pick the cheapest mode, GraphH-style (paper §II-D-2 pointer).

    Measures compression ratio and codec times on a sample shard, then
    chooses the mode minimising :func:`mode_iteration_cost`.  If mode-1
    already fits everything, compression is pure overhead and mode-1 wins
    by construction.
    """
    best_mode, best_cost = 1, float("inf")
    for mid, mode in MODES.items():
        t0 = time.perf_counter()
        blob = mode.compress(sample_raw)
        t_comp = time.perf_counter() - t0
        ratio = len(sample_raw) / max(len(blob), 1)
        t0 = time.perf_counter()
        mode.decompress(blob)
        t_dec = time.perf_counter() - t0
        per_byte = 1.0 / max(len(sample_raw), 1)
        cost = mode_iteration_cost(
            ratio, t_comp * per_byte, t_dec * per_byte,
            capacity_bytes, total_raw_bytes,
            disk_bw=disk_bw, lifetime_iters=lifetime_iters,
        )
        if cost < best_cost:
            best_mode, best_cost = mid, cost
    return best_mode
