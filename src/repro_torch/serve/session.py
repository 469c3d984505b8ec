"""Session result cache: (program, source, graph-version) -> QueryResult.

Per-source queries repeat heavily in serving workloads (the same handful of
sources dominate traffic), and a finished query's result is immutable until
the graph changes — so results are cached under a key that includes the
service's ``graph_version`` and hits bypass the lane queue entirely.
Bumping the version on a graph update invalidates every cached result
without scanning (stale keys simply age out of the LRU).

Thread-safe: ``submit`` runs on caller threads while the serve worker
populates entries.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

__all__ = ["SessionCache"]


class SessionCache:
    """Bounded LRU mapping of query keys to finished results."""

    def __init__(self, capacity: int = 256):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._items: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(
        self,
        key: Hashable,
        predicate: Optional[Callable[[Any], bool]] = None,
    ) -> Optional[Any]:
        """Look up ``key``; with ``predicate``, a present-but-unsuitable
        entry counts as a MISS (and is not refreshed) so the hit rate
        reflects queries actually served from cache."""
        with self._lock:
            if key in self._items:
                value = self._items[key]
                if predicate is None or predicate(value):
                    self._items.move_to_end(key)
                    self.hits += 1
                    return value
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
            self._items[key] = value
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)  # evict LRU

    def drop_stale_versions(self, current_version: int) -> int:
        """Remove entries cached under an older graph version.

        Version keys already make stale entries unreachable (lookups use
        the CURRENT version); this reclaims their capacity eagerly after a
        graph update instead of letting dead entries crowd out live ones.
        Keys are ``(program_key, source, graph_version)`` tuples — finer,
        per-shard invalidation would be unsound without tracking which
        shards each query's result depends on (any edge mutation can move
        any downstream distance/score).  Returns the number dropped.
        """
        with self._lock:
            stale = [
                k for k in self._items
                if isinstance(k, tuple) and k and k[-1] != current_version
            ]
            for k in stale:
                del self._items[k]
            return len(stale)

    def entries(self):
        """Snapshot of (key, value) pairs in LRU -> MRU order — the warm-
        state checkpoint (``repro_torch.checkpoint.warm_state``, once ported) persists these
        so a restarted service answers repeat queries from cache again."""
        with self._lock:
            return list(self._items.items())

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
