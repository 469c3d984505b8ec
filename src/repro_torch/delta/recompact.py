"""Recompactor: fold pending delta runs back into base shards.

The overlay keeps sweeps correct while deltas are pending, but every decode
of a dirty shard pays the fold (and ELL shards decode via CSR + a fresh
``csr_to_ell``).  Recompaction restores the fast path: for each dirty shard
it k-way-merges base keys + pending runs (tombstones applied in publish
order, inserts merged — the same :func:`~repro_torch.delta.overlay.apply_run`
fold the overlay uses, so the result is bitwise the overlay's view) and
rewrites the base CSR + ELL containers through ``ShardStore.write_shard``,
which fires the store's invalidation hooks — live engines drop stale cached
bytes and device-resident decodes automatically.  Fresh unique-source
arrays are re-deposited as warm state so engines rebuild that shard's Bloom
filter without another read.

Safety against live sweeps: absorbing runs ``<= S`` changes which state the
BASE bytes represent, so compaction (a) waits until no sweep is pinned
below ``S`` (:meth:`DeltaOverlay.wait_pins_below`) and (b) performs the
swap — staged base write + manifest flip + renames + run removal — under
the same per-shard lock the overlay decode takes.  A concurrent reader
pinned at ``v >= S`` therefore sees either (old base, runs ``<= S``
pending) or (new base, runs ``(S, v]`` pending); both decode to the same
logical shard.

Safety against crashes (DESIGN.md §12): the new base containers are staged
under ``delta_stage/`` and ONE atomic manifest write flips the shard —
floor advance and stage record land together — before any base file is
replaced.  A crash before the flip discards the stage (old base + runs
intact); a crash after it has recovery finish the renames and delete the
absorbed runs.  The old two-file overwrite could crash between the base
rewrite and the floor advance, double-applying the runs on reopen.

Triggers (``should_compact``): pending run count >= ``min_runs`` OR pending
delta bytes >= ``min_delta_frac`` of the base container.  ``compact()``
runs synchronously; ``start()`` runs the same policy on a background
thread, the LSM-style maintenance loop a serving deployment wants.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..core.ingest import csr_from_keys, keys_of_csr
from ..core.storage import DELTA_STAGE_DIR
from ..obs import trace
from .overlay import apply_run
from .recovery import crashpoint, stage_rel_name

__all__ = ["CompactionStats", "Recompactor"]


@dataclasses.dataclass
class CompactionStats:
    shards_compacted: int = 0
    runs_absorbed: int = 0
    inserts_applied: int = 0
    tombstones_applied: int = 0
    shard_bytes_written: int = 0

    def merge(self, other: "CompactionStats") -> None:
        self.shards_compacted += other.shards_compacted
        self.runs_absorbed += other.runs_absorbed
        self.inserts_applied += other.inserts_applied
        self.tombstones_applied += other.tombstones_applied
        self.shard_bytes_written += other.shard_bytes_written


class Recompactor:
    """Merge pending delta runs into new base shards (sync or background)."""

    def __init__(
        self,
        store,
        *,
        min_runs: int = 1,
        min_delta_frac: float = 0.0,
        interval_s: float = 0.05,
    ):
        if min_runs < 1:
            raise ValueError("min_runs must be >= 1")
        self.store = store
        self.overlay = store.ensure_delta()
        self.min_runs = min_runs
        self.min_delta_frac = min_delta_frac
        self.interval_s = interval_s
        self.total = CompactionStats()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # guards ``total`` merges
        # Lifecycle lock: start/stop may race (e.g. concurrent
        # GraphService.close calls); the maintenance thread itself never
        # takes it, so joining under it cannot deadlock.
        self._lifecycle_lock = threading.Lock()

    # ------------------------------------------------------------- policy
    def should_compact(self, p: int) -> bool:
        """Either trigger fires: pending run count reached ``min_runs``, or
        (when ``min_delta_frac > 0``) pending delta bytes reached that
        fraction of the base container.  A zero fraction disables the byte
        trigger rather than making it always-on — otherwise ``min_runs``
        could never batch runs up."""
        n_runs, _, _, pend_bytes = self.overlay.pending_stats(p)
        if n_runs == 0:
            return False
        if n_runs >= self.min_runs:
            return True
        if self.min_delta_frac <= 0.0:
            return False
        base = self.store.file_size(self.store.shard_name(p, "csr"))
        return pend_bytes >= self.min_delta_frac * max(base, 1)

    def dirty_shards(self) -> List[int]:
        return self.overlay.dirty_shards()

    # -------------------------------------------------------------- action
    def compact_shard(self, p: int) -> Optional[CompactionStats]:
        """Absorb shard ``p``'s runs up to the current version; returns the
        per-shard stats, or None if there was nothing to absorb (or a stop
        was requested while waiting for older sweep pins to drain)."""
        store, overlay = self.store, self.overlay
        s = overlay.version
        if not overlay.has_pending(p, s):
            return None
        if not overlay.wait_pins_below(s, stop=self._stop):
            return None
        with trace.span("compact.shard", shard=p, version=s) as sp:
            out = self._compact_locked(p, s, sp)
        return out

    def _compact_locked(self, p: int, s: int, sp) -> Optional[CompactionStats]:
        store, overlay = self.store, self.overlay
        meta = store.read_meta()
        ep = store.ell_params()
        with overlay.shard_lock(p):
            runs = overlay.pending_runs(p, s)
            if not runs:
                return None
            # fold base + runs <= s exactly as the overlay decodes them
            raw = store.shard_bytes(p, "csr")
            keys = keys_of_csr(store.decode_csr(p, raw))
            n_ins = n_tombs = 0
            for r in runs:
                tombs, ins = r.tombs(store), r.ins(store)
                keys = apply_run(keys, tombs, ins)
                n_ins += len(ins)
                n_tombs += len(tombs)
            v0, v1 = meta.interval_of(p)
            shard = csr_from_keys(p, v0, v1, keys)
            del keys
            # the swap (staged-rename protocol, DESIGN.md §12): encode the
            # new base into the staging dir, flip the manifest — floor
            # advance + stage record in ONE atomic write — then rename each
            # container into place and clean up; all under this shard's
            # overlay lock, so readers see old-base+runs or new-base, never
            # half of each, and a crash at any point recovers cleanly.
            csr_raw, ell_raw, _ = store.encode_shard(
                shard,
                num_vertices=meta.num_vertices,
                window=ep["window"], k=ep["k"], tr=ep["tr"],
            )
            csr_name = store.shard_name(p, "csr")
            ell_name = store.shard_name(p, "ell")
            os.makedirs(store._path(DELTA_STAGE_DIR), exist_ok=True)
            store.write_bytes(stage_rel_name(csr_name), csr_raw)
            store.write_bytes(stage_rel_name(ell_name), ell_raw)
            crashpoint("compact.staged")
            overlay.commit_compaction(p, s)  # COMMIT: the manifest flip
            crashpoint("compact.flipped")
            os.replace(store._path(stage_rel_name(csr_name)), store._path(csr_name))
            crashpoint("compact.csr_renamed")
            os.replace(store._path(stage_rel_name(ell_name)), store._path(ell_name))
            crashpoint("compact.renamed")
            store.invalidate_shard(p)  # hooks fire; warm state re-deposited
            store.set_warm_sources(p, np.unique(shard.col).astype(np.int64))
            overlay.clear_stage(p, s, runs)
        written = len(csr_raw) + len(ell_raw)
        st = CompactionStats(
            shards_compacted=1,
            runs_absorbed=len(runs),
            inserts_applied=n_ins,
            tombstones_applied=n_tombs,
            shard_bytes_written=written,
        )
        sp.set(runs=len(runs), inserts=n_ins, tombstones=n_tombs, bytes=written)
        with self._lock:
            self.total.merge(st)
        return st

    def compact(self, shards: Optional[Sequence[int]] = None) -> CompactionStats:
        """Synchronously compact ``shards`` (default: every dirty shard
        passing the trigger policy; pass an explicit list to force)."""
        agg = CompactionStats()
        if shards is None:
            shards = [p for p in self.dirty_shards() if self.should_compact(p)]
        for p in shards:
            st = self.compact_shard(p)
            if st is not None:
                agg.merge(st)
        return agg

    # ---------------------------------------------------------- background
    def start(self) -> None:
        """Run the trigger policy on a background maintenance thread."""
        with self._lifecycle_lock:
            if self._thread is not None:
                return
            self._stop.clear()

            def loop() -> None:
                while not self._stop.wait(self.interval_s):
                    try:
                        self.compact()
                    except Exception:  # maintenance must not kill the host
                        if self._stop.is_set():
                            return
                        raise

            self._thread = threading.Thread(
                target=loop, name="graphdelta-recompact", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        """Signal the maintenance thread and JOIN it — including any
        compaction it is mid-way through.  Idempotent and thread-safe:
        every concurrent caller blocks until the thread has fully exited
        (the old unguarded ``self._thread = None`` let a second closer
        return while a compaction still held shard locks)."""
        self._stop.set()
        with self._lifecycle_lock:
            if self._thread is not None:
                self._thread.join()
                self._thread = None

    def __enter__(self) -> "Recompactor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
