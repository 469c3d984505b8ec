"""Warm-restart checkpoints for the serving stack (DESIGN.md §12).

A cold ``GraphService`` boot pays one full pass over the store: every
shard is read once so the scheduler can build its Bloom/exact source
filters, the byte cache starts empty, and the session cache starts empty —
the first seconds after a restart are the slowest the service will ever
be.  None of that state is precious: all of it can be recomputed from the
store.  What a checkpoint buys is *time*: a snapshot of the warm state
lets a restarted process skip the filter-build read pass entirely and
answer repeat queries from cache immediately.

``WarmState`` captures, per snapshot:

- the per-shard unique-source arrays behind the Bloom/exact filters
  (``ShardScheduler.build_filters`` skips reading any shard whose sources
  were deposited via ``ShardStore.set_warm_sources``),
- the byte-cache warm set (shard ids, LRU -> MRU) — advisory: restoring
  it eagerly re-reads those shards, so it is applied only on request,
- the delta overlay coordinates it was taken at (publish ``version`` and
  per-shard absorbed ``floor``s) — the validity evidence,
- the service's ``graph_version`` and the session-cache entries (finished
  query results) at that version.

Validity is decided per shard at restore time, against the store as
recovered on disk (never the other way round — the checkpoint NEVER
overrides the store):

- the store must describe the same graph frame (``num_vertices``,
  ``num_shards``, intervals) and must not be *behind* the snapshot
  (``version >= snapshot version``; a lower version means the delta
  history was wiped, e.g. a re-ingest — everything is stale);
- a shard's sources are stale iff there is publish evidence past the
  snapshot: its floor or newest registered run seq exceeds the snapshot
  version.  Compaction alone never invalidates (it rewrites bytes, not
  logical content) — unless it absorbed runs the snapshot never saw,
  which is exactly the ``floor > snapshot version`` case;
- when both store and snapshot are at version 0 there is no delta
  history to compare, so the base container byte sizes stand in as the
  re-ingest detector: any mismatch rejects the whole snapshot;
- session entries are only valid when NOTHING changed:
  ``version == snapshot version`` exactly (and the frame checks pass).

Storage follows the reference package's checkpointer protocol — write
into ``warm_<step>.tmp/``, fsync-free atomic ``os.replace`` to
``warm_<step>/``, SHA-256 of the payload recorded in ``MANIFEST.json``,
bounded retention — and is numpy-only: restoring warm state must not drag
a device runtime into a serving boot.  The layout, ``MANIFEST.json`` and
SHA-256 are the reference package's, so a snapshot saved by either
package restores in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "SessionEntry",
    "WarmState",
    "WarmStateCheckpointer",
    "apply_warm_state",
    "capture_warm_state",
    "prewarm_cache",
]

_PREFIX = "warm_"
_FORMAT = 1


@dataclasses.dataclass
class SessionEntry:
    """One finished query result worth answering from cache after restart."""

    program: str  # program name as submitted
    key: Tuple  # LaneProgram.key (flat tuple of primitives)
    source: int
    values: np.ndarray
    iterations: int
    converged: bool


@dataclasses.dataclass
class WarmState:
    """Everything a restarted service can reuse instead of recompute."""

    store_version: int  # delta publish seq at snapshot (0 = base only)
    graph_version: int  # service-level version counter at snapshot
    num_vertices: int
    num_shards: int
    intervals: np.ndarray  # the store's destination intervals
    floors: Dict[int, int]  # shard -> absorbed watermark at snapshot
    bloom_sources: Dict[int, np.ndarray]  # shard -> unique source ids
    shard_sizes: Dict[int, int]  # shard -> base CSR container bytes
    cache_shards: Tuple[int, ...]  # byte-cache warm set, LRU -> MRU
    sessions: List[SessionEntry]


# --------------------------------------------------------------- capture
def capture_warm_state(service) -> WarmState:
    """Snapshot a live :class:`~repro_torch.serve.service.GraphService`.

    Safe while serving: every piece is either immutable or read through
    its owner's lock, and a publish racing the capture only makes the
    source arrays a *superset* of some consistent state — supersets cost
    wasted loads on the restarted engine, never correctness (the same
    contract ``ShardScheduler.refresh_shard_sources`` documents).
    """
    engine = service.engine
    store = engine.store
    meta = store.read_meta()
    delta = store.delta
    store_version = delta.version if delta is not None else 0
    floors = delta.floors() if delta is not None else {}

    srcs: Dict[int, np.ndarray] = {}
    exact = engine.scheduler.exact_sources or []
    for p, arr in enumerate(exact):
        if arr is not None:
            srcs[p] = np.asarray(arr, dtype=np.int64)
    sizes = {
        p: store.file_size(store.shard_name(p, "csr"))
        for p in range(meta.num_shards)
    }
    cache_shards = tuple(engine.cache.keys()) if engine.cache is not None else ()

    graph_version = service.graph_version
    sessions: List[SessionEntry] = []
    for key, qr in service.sessions.entries():
        # keys are (program_key_tuple, source, graph_version); only
        # current-version entries survive a restore anyway.
        if not (isinstance(key, tuple) and len(key) == 3):
            continue
        if key[2] != graph_version:
            continue
        sessions.append(
            SessionEntry(
                program=qr.program,
                key=tuple(key[0]),
                source=int(key[1]),
                values=np.asarray(qr.values),
                iterations=int(qr.iterations),
                converged=bool(qr.converged),
            )
        )
    return WarmState(
        store_version=store_version,
        graph_version=int(graph_version),
        num_vertices=int(meta.num_vertices),
        num_shards=int(meta.num_shards),
        intervals=np.asarray(meta.intervals, dtype=np.int64),
        floors=floors,
        bloom_sources=srcs,
        shard_sizes=sizes,
        cache_shards=cache_shards,
        sessions=sessions,
    )


# --------------------------------------------------------------- restore
def apply_warm_state(store, ws: WarmState) -> Dict:
    """Deposit the snapshot's still-valid warm sources into ``store``.

    Runs BEFORE the engine is constructed: every shard whose sources are
    deposited is skipped by ``ShardScheduler.build_filters`` — the whole
    point of the exercise.  Returns a report dict:

    ``valid``            whether the snapshot matched the store at all
    ``reason``           why not (when ``valid`` is False)
    ``shards_warm``      shards whose sources were deposited
    ``shards_stale``     shards skipped for publish evidence past the snapshot
    ``sessions_valid``   whether cached query results may be restored
    """
    report = {
        "valid": False,
        "reason": "",
        "shards_warm": 0,
        "shards_stale": 0,
        "sessions_valid": False,
    }
    meta = store.read_meta()
    if (
        int(meta.num_vertices) != ws.num_vertices
        or int(meta.num_shards) != ws.num_shards
        or not np.array_equal(
            np.asarray(meta.intervals, np.int64),
            np.asarray(ws.intervals, np.int64),
        )
    ):
        report["reason"] = "graph frame mismatch (re-ingested store?)"
        return report
    delta = store.delta
    cur_version = delta.version if delta is not None else 0
    if cur_version < ws.store_version:
        report["reason"] = (
            f"store version {cur_version} behind snapshot "
            f"{ws.store_version} (delta history wiped)"
        )
        return report
    if cur_version == 0 and ws.store_version == 0:
        # No delta history on either side: base byte sizes are the only
        # re-ingest evidence left.
        for p, size in ws.shard_sizes.items():
            if store.file_size(store.shard_name(int(p), "csr")) != size:
                report["reason"] = f"shard {p} container size changed"
                return report
    report["valid"] = True
    floors = delta.floors() if delta is not None else {}
    for p, arr in ws.bloom_sources.items():
        p = int(p)
        floor = floors.get(p, 0)
        last = delta.last_publish_seq(p) if delta is not None else 0
        if floor > ws.store_version or last > ws.store_version:
            report["shards_stale"] += 1  # published past the snapshot
            continue
        store.set_warm_sources(p, np.asarray(arr, dtype=np.int64))
        report["shards_warm"] += 1
    report["sessions_valid"] = cur_version == ws.store_version
    return report


def prewarm_cache(engine, ws: WarmState) -> int:
    """Eagerly re-populate the engine's byte cache with the snapshot's warm
    set (clean shards only — dirty shards' slots belong to the overlay's
    CSR path).  This READS those shards: it trades boot-time I/O for
    first-query cache hits, so it is opt-in.  Returns shards inserted."""
    if engine.cache is None:
        return 0
    delta = engine.store.delta
    n = 0
    for p in ws.cache_shards:
        p = int(p)
        if p < 0 or p >= engine.meta.num_shards:
            continue
        if delta is not None and delta.has_pending(p):
            continue
        raw = engine.store.shard_bytes(p, engine._fmt)
        if engine.cache.put(p, raw):
            n += 1
    return n


# --------------------------------------------------------------- on disk
class WarmStateCheckpointer:
    """Atomic, retained, integrity-checked WarmState snapshots on disk.

    Layout (per step)::

        <directory>/warm_00000003/
            state.npz       # every array: sources, intervals, values, ...
            MANIFEST.json   # scalars + session metadata + sha256(state.npz)

    The reference package's checkpointer commit protocol: stage into
    ``warm_<step>.tmp/``, single ``os.replace`` to commit, retention GC
    afterwards.  A crash mid-save leaves a
    ``.tmp`` dir that the next save of the same step overwrites and
    ``latest_step`` never selects.
    """

    def __init__(self, directory: str, *, keep: int = 2):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- naming
    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len(_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # --------------------------------------------------------------- save
    def save(self, state: WarmState, *, step: Optional[int] = None) -> str:
        if step is None:
            latest = self.latest_step()
            step = 0 if latest is None else latest + 1
        arrays = {
            "intervals": np.asarray(state.intervals, np.int64),
            "floors": np.asarray(
                sorted((int(p), int(s)) for p, s in state.floors.items()),
                dtype=np.int64,
            ).reshape(-1, 2),
            "shard_sizes": np.asarray(
                sorted((int(p), int(s)) for p, s in state.shard_sizes.items()),
                dtype=np.int64,
            ).reshape(-1, 2),
            "cache_shards": np.asarray(state.cache_shards, dtype=np.int64),
        }
        for p, arr in state.bloom_sources.items():
            arrays[f"src_{int(p)}"] = np.asarray(arr, np.int64)
        for i, e in enumerate(state.sessions):
            arrays[f"sess_{i}"] = np.asarray(e.values)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        payload = buf.getvalue()
        manifest = {
            "format": _FORMAT,
            "step": int(step),
            "store_version": int(state.store_version),
            "graph_version": int(state.graph_version),
            "num_vertices": int(state.num_vertices),
            "num_shards": int(state.num_shards),
            "sessions": [
                {
                    "program": e.program,
                    "key": list(e.key),
                    "source": int(e.source),
                    "iterations": int(e.iterations),
                    "converged": bool(e.converged),
                }
                for e in state.sessions
            ],
            "sha256": hashlib.sha256(payload).hexdigest(),
        }
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "state.npz"), "wb") as f:
            f.write(payload)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # the commit point
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------ restore
    def restore(self, step: Optional[int] = None) -> WarmState:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no warm-state snapshot under {self.directory}"
                )
        d = self._dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            man = json.load(f)
        with open(os.path.join(d, "state.npz"), "rb") as f:
            payload = f.read()
        digest = hashlib.sha256(payload).hexdigest()
        if digest != man["sha256"]:
            raise IOError(
                f"warm-state payload corrupt at step {step}: "
                f"sha256 {digest} != manifest {man['sha256']}"
            )
        z = np.load(io.BytesIO(payload))
        sessions = [
            SessionEntry(
                program=s["program"],
                key=tuple(s["key"]),
                source=int(s["source"]),
                values=z[f"sess_{i}"],
                iterations=int(s["iterations"]),
                converged=bool(s["converged"]),
            )
            for i, s in enumerate(man["sessions"])
        ]
        return WarmState(
            store_version=int(man["store_version"]),
            graph_version=int(man["graph_version"]),
            num_vertices=int(man["num_vertices"]),
            num_shards=int(man["num_shards"]),
            intervals=z["intervals"],
            floors={int(p): int(s) for p, s in z["floors"]},
            bloom_sources={
                int(k[len("src_"):]): z[k]
                for k in z.files
                if k.startswith("src_")
            },
            shard_sizes={int(p): int(s) for p, s in z["shard_sizes"]},
            cache_shards=tuple(int(p) for p in z["cache_shards"]),
            sessions=sessions,
        )
