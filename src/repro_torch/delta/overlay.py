"""DeltaOverlay: versioned merge of base shards + pending delta runs.

The overlay is the read side of GraphDelta (DESIGN.md §8).  A store's base
shards stay immutable between recompactions; every published update batch
adds one *delta run* per affected shard — a file of destination-sorted
``(dst << 32) | src`` insert keys plus unique tombstone keys (deletes).
``load_logical`` reconstructs the CURRENT logical shard by folding the
pending runs over the base CSR in publish order:

    keys := base_keys
    for run in runs(floor < seq <= pin):      # publish order
        keys := merge(keys \\ run.tombs, run.ins)

Because the fold operates on exactly the sort keys the external build uses
(``repro_torch.core.ingest``), the result is bitwise what a from-scratch build of
the mutated edge list (same intervals) would produce — tombstones remove
ALL copies of an edge, inserts add one copy, and a later batch's insert
survives an earlier batch's tombstone by construction of the publish fold
(``repro_torch.delta.edgelog``).

Version/snapshot semantics
--------------------------
``version`` is the publish sequence number (0 = base only).  A sweep PINS
the version it starts at (:meth:`acquire_pin`); every decode during that
sweep applies runs up to the pin only, so one sweep never mixes two graph
versions.  Publishes happen strictly *between* sweeps in the serving layer;
pins exist so background recompaction can also run safely: absorbing runs
``<= S`` into the base waits until no active pin is below ``S``
(:meth:`wait_pins_below`), and the per-shard swap (base rewrite + floor
advance) happens under the same per-shard lock every overlay decode takes —
a concurrent reader sees either (old base, runs ``<= S`` pending) or
(new base, runs ``<= S`` absorbed), never half of each.

Durability: run files live in the store (accounted channel) and
``delta_manifest.json`` is the ONLY commit record — one atomic write flips
a publish (version + metadata journal ref) or a compaction (floor + stage
record) in its entirety.  On open, :func:`repro_torch.delta.recovery.recover`
rolls every interrupted protocol forward or back from the manifest alone:
uncommitted runs/journals/staged files are deleted, a committed publish's
metadata journal is replayed, a committed compaction's staged renames are
finished.  See DESIGN.md §12 for the full state machine.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.csr import csr_to_ell
from ..core.ingest import csr_from_keys, keys_of_csr, kway_merge
from ..core.storage import (
    DELTA_MANIFEST,
    DELTA_RUN_PREFIX,
    _load_npz_bytes,
    _save_npz_bytes,
)
from ..obs import trace

from . import recovery as _recovery
from .recovery import crashpoint

__all__ = ["DeltaRun", "DeltaOverlay", "apply_run", "tombstoned_mask",
           "run_name"]

_KEY_DTYPE = np.dtype("<i8")


def run_name(shard_id: int, seq: int) -> str:
    return f"{DELTA_RUN_PREFIX}{shard_id:05d}_{seq:07d}.npz"


def tombstoned_mask(keys: np.ndarray, tombs: np.ndarray) -> np.ndarray:
    """Bool mask over ``keys`` marking entries present in the sorted-unique
    tombstone array — the one membership primitive every delta fold uses
    (drop = ``keys[~mask]``, removed-multiplicity = ``keys[mask]``)."""
    if len(tombs) == 0 or len(keys) == 0:
        return np.zeros(len(keys), dtype=bool)
    pos = np.minimum(np.searchsorted(tombs, keys), len(tombs) - 1)
    return tombs[pos] == keys


def apply_run(
    keys: np.ndarray, tombs: np.ndarray, ins: np.ndarray
) -> np.ndarray:
    """One fold step: drop ALL copies of tombstoned keys, merge inserts.

    ``keys`` and ``ins`` are sorted (possibly with duplicates); ``tombs`` is
    sorted unique.  Output is sorted — merging two sorted arrays preserves
    the (dst, src) lexicographic order the shard format requires.
    """
    if len(tombs) and len(keys):
        keys = keys[~tombstoned_mask(keys, tombs)]
    if len(ins):
        keys = kway_merge([keys, ins])
    return keys


class DeltaRun:
    """One published delta run for one shard (lazy-loaded, then cached)."""

    __slots__ = ("shard_id", "seq", "name", "n_ins", "n_tombs", "nbytes",
                 "_ins", "_tombs")

    def __init__(self, shard_id: int, seq: int, name: str,
                 n_ins: int = -1, n_tombs: int = -1, nbytes: int = 0):
        self.shard_id = shard_id
        self.seq = seq
        self.name = name
        self.n_ins = n_ins
        self.n_tombs = n_tombs
        self.nbytes = nbytes
        self._ins: Optional[np.ndarray] = None
        self._tombs: Optional[np.ndarray] = None

    @staticmethod
    def encode(ins: np.ndarray, tombs: np.ndarray) -> bytes:
        return _save_npz_bytes(
            ins=ins.astype(_KEY_DTYPE), tombs=tombs.astype(_KEY_DTYPE)
        )

    def set_arrays(self, ins: np.ndarray, tombs: np.ndarray) -> None:
        self._ins, self._tombs = ins, tombs
        self.n_ins, self.n_tombs = len(ins), len(tombs)

    def _load(self, store) -> None:
        if self._ins is None:
            z = _load_npz_bytes(store.read_bytes(self.name))
            self.set_arrays(z["ins"], z["tombs"])

    def ins(self, store) -> np.ndarray:
        self._load(store)
        return self._ins

    def tombs(self, store) -> np.ndarray:
        self._load(store)
        return self._tombs

    def insert_sources(self, store) -> np.ndarray:
        """Unique source vertex ids this run inserts (Bloom refresh input)."""
        return np.unique(self.ins(store) & 0xFFFFFFFF).astype(np.int64)


class DeltaOverlay:
    """Pending-mutation state of one :class:`~repro_torch.core.storage.ShardStore`."""

    def __init__(self, store):
        self.store = store
        self._lock = threading.Lock()
        self._shard_locks: Dict[int, threading.Lock] = {}
        self._runs: Dict[int, List[DeltaRun]] = {}
        self._floor: Dict[int, int] = {}  # runs <= floor[p] absorbed in base
        self._last_publish: Dict[int, int] = {}  # p -> newest publish seq
        self.version = 0
        self._num_vertices: Optional[int] = None
        # active sweep pins: version -> refcount
        self._pins: Dict[int, int] = {}
        self._pin_cond = threading.Condition(self._lock)
        # shards whose committed compaction is mid-swap: p -> absorbed seq.
        # Recorded in the manifest so recovery can finish the staged
        # renames; empty except inside commit_compaction..clear_stage.
        self._stage: Dict[int, int] = {}
        # Serializes the manifest PROTOCOL sections (publish commit,
        # compaction flip) against each other — a background compaction's
        # manifest write must never clobber a publish's journal-bearing
        # manifest mid-protocol.  Ordering: shard_lock -> _commit_lock ->
        # _lock; _lock is never held while taking either of the others.
        self._commit_lock = threading.Lock()
        self._recover()

    # ------------------------------------------------------------ recovery
    def _recover(self) -> None:
        """Delegate to the recovery state machine (repro_torch.delta.recovery):
        replays a committed publish's metadata journal, finishes a
        committed compaction's staged renames, deletes uncommitted
        runs/journals/staged files, and registers the surviving runs.
        The report is kept on ``self.last_recovery`` — a clean open has
        ``last_recovery.acted == False``."""
        self.last_recovery = _recovery.recover(self)

    def _write_manifest(
        self, *, version: Optional[int] = None, journal: Optional[int] = None
    ) -> None:
        """Write the commit record (atomic tmp+rename).  ``version``
        overrides ``self.version`` (publish commits the new version on disk
        BEFORE making it visible in memory); ``journal`` records a pending
        metadata journal; any active stage records ride along — and the
        written floor folds them in (a stage record MEANS "floor advanced
        to s, renames pending"), while the in-memory floor stays behind
        until :meth:`clear_stage` so live readers keep folding the pending
        runs over the OLD base until the new one is actually in place."""
        floor = dict(self._floor)
        for p, s in self._stage.items():
            floor[p] = max(floor.get(p, 0), s)
        man = {
            "version": self.version if version is None else version,
            "floor": {str(p): s for p, s in floor.items()},
        }
        if self._stage:
            man["stage"] = {str(p): s for p, s in self._stage.items()}
        if journal is not None:
            man["journal"] = journal
        self.store.write_bytes(DELTA_MANIFEST, json.dumps(man).encode())

    # ------------------------------------------------------------- queries
    def shard_lock(self, p: int) -> threading.Lock:
        with self._lock:
            lock = self._shard_locks.get(p)
            if lock is None:
                lock = self._shard_locks[p] = threading.Lock()
            return lock

    def _pending(self, p: int, pin: Optional[int]) -> List[DeltaRun]:
        v = self.version if pin is None else pin
        lo = self._floor.get(p, 0)
        return [r for r in self._runs.get(p, ()) if lo < r.seq <= v]

    def has_pending(self, p: int, pin: Optional[int] = None) -> bool:
        with self._lock:
            return bool(self._pending(p, pin))

    def pending_runs(self, p: int, pin: Optional[int] = None) -> List[DeltaRun]:
        with self._lock:
            return list(self._pending(p, pin))

    def dirty_shards(self) -> List[int]:
        with self._lock:
            return sorted(p for p in self._runs if self._pending(p, None))

    def pending_stats(self, p: int) -> Tuple[int, int, int, int]:
        """(runs, inserts, tombstones, bytes) pending for shard ``p``."""
        runs = self.pending_runs(p)
        for r in runs:
            if r.n_ins < 0:
                r._load(self.store)
        return (
            len(runs),
            sum(r.n_ins for r in runs),
            sum(r.n_tombs for r in runs),
            sum(r.nbytes for r in runs),
        )

    def floors(self) -> Dict[int, int]:
        """Snapshot of the per-shard absorbed-watermark map (shard ->
        highest publish seq folded into its base)."""
        with self._lock:
            return dict(self._floor)

    def last_publish_seq(self, p: int) -> int:
        """Newest publish seq known to have touched shard ``p`` (0 = never;
        absorbed runs forget this after a restart — combine with
        :meth:`floors` for publish evidence across restarts)."""
        with self._lock:
            return self._last_publish.get(p, 0)

    def publishes_since(self, seen_version: int) -> List[int]:
        """Shards touched by any publish after ``seen_version`` (still
        reported after recompaction absorbs the runs — consumers patching
        Bloom/source filters must not miss absorbed inserts)."""
        with self._lock:
            return sorted(
                p for p, s in self._last_publish.items() if s > seen_version
            )

    def pending_insert_sources(self, p: int, pin: Optional[int] = None) -> np.ndarray:
        runs = self.pending_runs(p, pin)
        if not runs:
            return np.empty(0, dtype=np.int64)
        srcs = [r.insert_sources(self.store) for r in runs]
        return np.unique(np.concatenate(srcs))

    # ---------------------------------------------------------------- pins
    def acquire_pin(self) -> int:
        with self._lock:
            v = self.version
            self._pins[v] = self._pins.get(v, 0) + 1
            return v

    def release_pin(self, v: int) -> None:
        with self._lock:
            n = self._pins.get(v, 0) - 1
            if n <= 0:
                self._pins.pop(v, None)
            else:
                self._pins[v] = n
            self._pin_cond.notify_all()

    @contextlib.contextmanager
    def pinned(self):
        v = self.acquire_pin()
        try:
            yield v
        finally:
            self.release_pin(v)

    def wait_pins_below(self, s: int, *, stop: Optional[threading.Event] = None,
                        timeout: float = 0.1) -> bool:
        """Block until no active pin is below ``s`` (so absorbing runs
        ``<= s`` into the base cannot change what a live sweep decodes).
        Returns False if ``stop`` was set while waiting."""
        with self._lock:
            while any(v < s for v in self._pins):
                if stop is not None and stop.is_set():
                    return False
                self._pin_cond.wait(timeout)
        return True

    # ------------------------------------------------------------- decode
    def _num_v(self) -> int:
        if self._num_vertices is None:
            self._num_vertices = self.store.read_meta().num_vertices
        return self._num_vertices

    def logical_keys(self, p: int, pin: Optional[int] = None,
                     *, raw: Optional[bytes] = None) -> np.ndarray:
        """Sorted packed keys of the logical shard at ``pin`` (no locking —
        callers hold :meth:`shard_lock` when racing a compaction swap)."""
        store = self.store
        if raw is None:
            raw = store.shard_bytes(p, "csr")
        keys = keys_of_csr(store.decode_csr(p, raw))
        for r in self.pending_runs(p, pin):
            keys = apply_run(keys, r.tombs(store), r.ins(store))
        return keys

    def load_logical(self, p: int, fmt: str = "csr", *,
                     pin: Optional[int] = None, cache=None):
        """Decode the LOGICAL shard (base + pending runs at ``pin``).

        Returns the ShardCSR / EllShard the consumer would have seen from a
        store whose base already contained the mutations.  The per-shard
        lock makes the (base bytes, applicable runs) pair atomic against a
        concurrent recompaction swap.  When ``cache`` is given it is
        consulted/filled with the base **CSR** container bytes — a shard
        with pending deltas always caches CSR bytes (the only format the
        overlay can merge); the publish/compact invalidation hooks drop the
        entry whenever the shard flips between pending and clean, so one
        cache slot never holds ambiguous bytes.
        """
        store = self.store
        with trace.span("overlay.merge", shard=p) as sp:
            with self.shard_lock(p):
                gen0 = store.shard_generation(p)
                from_cache = False
                raw = cache.get(p) if cache is not None else None
                if raw is not None:
                    from_cache = True
                else:
                    raw = store.shard_bytes(p, "csr")
                    if cache is not None:
                        cache.put(p, raw)
                        if store.shard_generation(p) != gen0:
                            cache.invalidate(p)  # raced with a swap/overwrite
                base = store.decode_csr(p, raw)
                sp.set(runs=len(self.pending_runs(p, pin)), from_cache=from_cache)
                keys = self.logical_keys(p, pin, raw=raw)
            csr = csr_from_keys(p, base.v0, base.v1, keys)
            if fmt == "csr":
                return csr, from_cache
            ep = store.ell_params()
            ell = csr_to_ell(
                csr, self._num_v(),
                window=ep["window"], k=ep["k"], tr=ep["tr"],
            )
            return ell, from_cache

    # --------------------------------------------------------- publication
    def commit_publish(
        self,
        seq: int,
        runs: List[DeltaRun],
        touched: List[int],
        *,
        meta=None,
        journal: Optional[str] = None,
    ) -> None:
        """Commit a published batch (crash-atomic, DESIGN.md §12).

        The caller (``EdgeLog.publish``) has already written the run files
        and the metadata journal ``journal`` (absolute post-publish degree
        rows).  Protocol, under the commit lock:

        1. manifest gains ``{"version": seq, "journal": seq}`` — THE commit
           point.  A crash before this write loses the publish entirely
           (recovery deletes the orphan files); a crash after it keeps the
           publish entirely (recovery replays the journal).
        2. updated metadata ``meta`` is written.  Only now — never before
           the commit — so a crash can no longer leave degree arrays ahead
           of discarded runs (the stale-degree window).
        3. in-memory registration: runs + version become visible.  Deferred
           to here so concurrent readers never see the new version while
           the on-disk metadata still lags it; guaranteed (``finally``)
           even if step 2 raised, because the commit already happened.
        4. the journal ref is cleared from the manifest and the journal
           file removed.

        After the commit the method invalidates decoded/cached copies of
        the touched shards.  Base bytes are unchanged by a publish, so warm
        base-source arrays survive (``drop_warm=False``).

        Raises only for pre-commit failures (the manifest write itself);
        the caller distinguishes via ``overlay.version``: still below
        ``seq`` means nothing committed and the files must be scrubbed.
        """
        with self._commit_lock:
            self._write_manifest(
                version=seq, journal=seq if journal is not None else None
            )
            # committed: everything below must leave a recoverable state
            try:
                crashpoint("publish.committed")
                if meta is not None:
                    self.store.write_meta(meta)
                crashpoint("publish.meta_written")
            finally:
                with self._lock:
                    for r in runs:
                        self._runs.setdefault(r.shard_id, []).append(r)
                        self._last_publish[r.shard_id] = seq
                    self.version = seq
            with self._lock:
                self._write_manifest()
            if journal is not None:
                try:
                    os.remove(self.store._path(journal))
                except OSError:
                    pass
        for p in touched:
            self.store.invalidate_shard(p, drop_warm=False)

    # --------------------------------------------------------- compaction
    def commit_compaction(self, p: int, upto_seq: int) -> None:
        """Atomically flip shard ``p`` to its staged base (DESIGN.md §12):
        ONE manifest write advances the on-disk floor to ``upto_seq`` AND
        records the stage, so recovery either sees neither (old base +
        runs — the compaction never happened) or both (it finishes the
        renames and drops the absorbed runs) — never a floor that advanced
        without its new base, nor pending runs re-applied onto a base that
        already absorbed them.

        In-memory floor/run state is deliberately NOT touched here: until
        the renames land (:meth:`clear_stage`), live readers must keep
        seeing the shard as dirty, so their decodes take the overlay path
        and serialize on the shard lock the compactor holds — a clean-path
        reader checks ``has_pending`` WITHOUT that lock and would otherwise
        read the old base with the runs already dropped.  Caller holds the
        shard lock and has written the staged containers."""
        with self._commit_lock:
            with self._lock:
                self._stage[p] = upto_seq
                self._write_manifest()  # folds the stage into the floor

    def clear_stage(self, p: int, upto_seq: int, runs: List[DeltaRun]) -> None:
        """Staged containers are renamed into place: make the absorption
        visible in memory (floor advance + run pruning), drop the stage
        record, then remove the absorbed run files.  Run-file deletion is
        safe last — recovery deletes runs at or below the manifest floor
        itself."""
        with self._commit_lock:
            with self._lock:
                self._floor[p] = max(self._floor.get(p, 0), upto_seq)
                keep = [r for r in self._runs.get(p, ()) if r.seq > upto_seq]
                if keep:
                    self._runs[p] = keep
                else:
                    self._runs.pop(p, None)
                self._stage.pop(p, None)
                self._write_manifest()
        for r in runs:
            try:
                os.remove(self.store._path(r.name))
            except OSError:
                pass
