"""EdgeLog: staged edge mutations flushed into per-shard delta runs.

Write side of GraphDelta (DESIGN.md §8).  Callers :meth:`append` batches of
edge inserts/deletes; :meth:`publish` folds every staged batch into AT MOST
one delta run per affected shard and commits them CRASH-atomically
(DESIGN.md §12: run files → metadata journal → one-write manifest commit →
metadata), advancing the overlay version by one.  A crash anywhere leaves
either no trace of the publish or all of it — recovery replays the
journaled metadata of a committed publish and scrubs the files of an
uncommitted one.

Batch semantics (the contract the bitwise tests enforce):

- the logical graph is an edge *multiset* over a FIXED vertex set
  (``0 .. num_vertices``); inserts add one copy (duplicates allowed, as in
  ``preprocess``), deletes remove ALL copies of the named edge (a delete of
  an absent edge is a no-op),
- within one batch deletes apply before inserts,
- batches apply in append order.

The publish fold turns that sequential semantics into a single
``(tombstones, inserts)`` pair per shard: a later batch's delete also
cancels earlier staged inserts of the same edge, and a later batch's insert
survives earlier tombstones because tombstones only ever apply to state
*below* the run's sequence number.  Routing/packing reuses the streamed
ingest machinery (``route_edges`` — destination shard by interval,
``(dst << 32) | src`` keys), so a delta run is "just another sorted run"
for the recompactor's k-way merge.

Degree accounting: deletes must know how many copies they removed, so a
publish with tombstones reads the affected shards' CURRENT logical keys
(base + earlier pending runs) once — O(affected shards), never O(|E|) —
and the updated in/out-degree arrays + edge count are persisted with the
publish, keeping ``GraphMeta`` bitwise-equal to a from-scratch build of
the mutated edge list.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.ingest import kway_merge, route_edges

from .overlay import DeltaRun, run_name, tombstoned_mask
from .recovery import crashpoint, encode_journal, journal_name

__all__ = ["EdgeLog", "PublishResult"]


@dataclasses.dataclass
class PublishResult:
    """What one publish did: the version it created and its extent."""

    version: int
    batches: int = 0
    edges_inserted: int = 0
    edges_removed: int = 0  # copies actually removed (not tombstones named)
    shards_touched: Tuple[int, ...] = ()
    run_bytes_written: int = 0


def _norm_edges(edges, num_vertices: int, what: str):
    """Accept ``(src, dst)`` array pair or an ``[N, 2]`` array; validate."""
    if edges is None:
        return None
    if isinstance(edges, tuple) and len(edges) == 2:
        src = np.asarray(edges[0], dtype=np.int64).ravel()
        dst = np.asarray(edges[1], dtype=np.int64).ravel()
    else:
        arr = np.asarray(edges, dtype=np.int64)
        if arr.size == 0:
            return None
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"{what}: expected (src, dst) arrays or [N, 2]")
        src, dst = arr[:, 0], arr[:, 1]
    if src.shape != dst.shape:
        raise ValueError(f"{what}: src/dst length mismatch")
    if len(src) == 0:
        return None
    lo = min(int(src.min()), int(dst.min()))
    hi = max(int(src.max()), int(dst.max()))
    if lo < 0 or hi >= num_vertices:
        raise ValueError(
            f"{what}: vertex id out of range [0, {num_vertices}): "
            f"min={lo} max={hi}"
        )
    return src.astype(np.int32), dst.astype(np.int32)


class EdgeLog:
    """Stage insert/delete batches against a live store and publish them."""

    def __init__(self, store, *, chunk_edges: int = 1 << 20):
        self.store = store
        self.overlay = store.ensure_delta()
        self.chunk_edges = max(1, int(chunk_edges))
        self._staged: List[Tuple] = []  # (ins or None, dels or None)
        self._lock = threading.Lock()
        self._num_vertices = store.read_meta().num_vertices

    # -------------------------------------------------------------- staging
    def append(self, inserts=None, deletes=None) -> int:
        """Stage one mutation batch; returns the staged-batch count.

        ``inserts`` / ``deletes`` are ``(src, dst)`` array pairs (or
        ``[N, 2]`` arrays).  Nothing is visible until :meth:`publish`.
        """
        ins = _norm_edges(inserts, self._num_vertices, "inserts")
        dels = _norm_edges(deletes, self._num_vertices, "deletes")
        with self._lock:
            if ins is not None or dels is not None:
                self._staged.append((ins, dels))
            return len(self._staged)

    @property
    def staged_batches(self) -> int:
        with self._lock:
            return len(self._staged)

    def _route(self, src: np.ndarray, dst: np.ndarray, intervals):
        """Chunked scatter (bounds the argsort working set for big batches)."""
        for lo in range(0, len(src), self.chunk_edges):
            yield from route_edges(
                intervals, src[lo: lo + self.chunk_edges],
                dst[lo: lo + self.chunk_edges],
            )

    # ------------------------------------------------------------- publish
    def publish(self) -> PublishResult:
        """Fold all staged batches into one delta run per affected shard,
        write + commit them, and return the new version."""
        with self._lock:
            staged, self._staged = self._staged, []
        overlay, store = self.overlay, self.store
        if not staged:
            return PublishResult(version=overlay.version)

        meta = store.read_meta()
        intervals = meta.intervals
        tomb_acc = {}  # p -> sorted unique tombstone keys
        ins_acc = {}  # p -> sorted insert keys (multiset)
        for ins, dels in staged:
            if dels is not None:
                for p, keys in self._route(dels[0], dels[1], intervals):
                    t = np.unique(keys)
                    pend = ins_acc.get(p)
                    if pend is not None and len(pend):
                        # this batch's delete removes earlier staged copies
                        ins_acc[p] = pend[~tombstoned_mask(pend, t)]
                    prev = tomb_acc.get(p)
                    tomb_acc[p] = t if prev is None else np.union1d(prev, t)
            if ins is not None:
                for p, keys in self._route(ins[0], ins[1], intervals):
                    ins_acc[p] = kway_merge(
                        [ins_acc.get(p, keys[:0]), np.sort(keys)]
                    )

        touched = sorted(
            p for p in set(tomb_acc) | set(ins_acc)
            if len(tomb_acc.get(p, ())) or len(ins_acc.get(p, ()))
        )
        if not touched:
            # every staged batch cancelled out — nothing becomes visible
            return PublishResult(version=overlay.version, batches=len(staged))

        seq = overlay.version + 1
        runs: List[DeltaRun] = []
        added_total = removed_total = run_bytes = 0
        empty = np.empty(0, dtype=np.int64)
        vid_parts: List[np.ndarray] = []  # endpoints whose degrees change
        try:
            first_run = True
            for p in touched:
                tombs = tomb_acc.get(p, empty)
                ins = ins_acc.get(p, empty)
                removed = empty
                if len(tombs):
                    # exact removed multiplicities need current logical keys
                    with overlay.shard_lock(p):
                        cur = overlay.logical_keys(p)
                    removed = cur[tombstoned_mask(cur, tombs)]
                for arr, sign in ((ins, 1), (removed, -1)):
                    if len(arr):
                        np.add.at(meta.out_deg, arr & 0xFFFFFFFF, sign)
                        np.add.at(meta.in_deg, arr >> 32, sign)
                        vid_parts.append(arr & 0xFFFFFFFF)
                        vid_parts.append(arr >> 32)
                added_total += len(ins)
                removed_total += len(removed)
                raw = DeltaRun.encode(ins, tombs)
                name = run_name(p, seq)
                store.write_bytes(name, raw)
                if first_run:
                    crashpoint("publish.first_run")
                    first_run = False
                run_bytes += len(raw)
                run = DeltaRun(p, seq, name, nbytes=len(raw))
                run.set_arrays(ins, tombs)
                runs.append(run)
            crashpoint("publish.runs_written")

            # Metadata journal (DESIGN.md §12): ABSOLUTE post-publish degree
            # rows for every touched vertex + the new edge count, durable
            # BEFORE the manifest commit.  Replay at recovery is idempotent,
            # so a crash anywhere after the commit still converges to the
            # published metadata.
            meta.num_edges += added_total - removed_total
            vids = (
                np.unique(np.concatenate(vid_parts)).astype(np.int64)
                if vid_parts else empty
            )
            journal = journal_name(seq)
            store.write_bytes(journal, encode_journal(meta, vids, meta.num_edges))
            crashpoint("publish.journal_written")

            # One atomic manifest write commits the publish; metadata is
            # applied AFTER it (stale-degree window closed), and only a
            # committed publish bumps overlay.version.
            overlay.commit_publish(seq, runs, touched, meta=meta, journal=journal)
        except BaseException:
            if overlay.version < seq:
                # Not committed: nothing became visible, but files written
                # at ``seq`` must not linger — a LATER successful publish
                # commits the same seq, and recovery would then legitimize
                # these orphans as published runs.  Scrub by NAME for every
                # touched shard (not just registered DeltaRuns — a write
                # that raised after landing its file never registered one)
                # plus the journal.
                for name in [run_name(p, seq) for p in touched] + [journal_name(seq)]:
                    try:
                        os.remove(store._path(name))
                    except OSError:
                        pass
            raise
        return PublishResult(
            version=seq,
            batches=len(staged),
            edges_inserted=added_total,
            edges_removed=removed_total,
            shards_touched=tuple(touched),
            run_bytes_written=run_bytes,
        )
