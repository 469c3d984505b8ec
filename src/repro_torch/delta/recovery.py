"""Crash recovery for GraphDelta: journal replay + staged-rename completion.

DESIGN.md §12.  The delta layer's durable state is a set of per-shard run
files, the metadata pair (``property.json`` / ``vertexinfo.npz``), the base
shard containers, and ONE commit record — ``delta_manifest.json``, always
written via the store's atomic tmp+rename channel.  Every multi-file
protocol (publish, compaction) is arranged so that a crash at ANY point
leaves the store in a state this module can roll forward or back from,
using only the manifest:

Publish (``EdgeLog.publish`` / ``DeltaOverlay.commit_publish``)::

    run files            delta_run_<shard>_<seq>.npz, one per touched shard
    metadata journal     delta_journal_<seq>.npz — ABSOLUTE post-publish
                         degree rows for the touched vertices + edge count
    COMMIT               manifest gains {"version": seq, "journal": seq}
    metadata             property.json + vertexinfo.npz rewritten
    clear                manifest rewritten without "journal"; journal file
                         removed

    crash before COMMIT  -> run files / journal at seq > version: deleted
    crash after  COMMIT  -> journal replayed onto the metadata (idempotent:
                            absolute values, not deltas), then cleared

Compaction (``Recompactor._compact_locked``)::

    staged containers    delta_stage/shard_<p>.{csr,ell}.npz
    COMMIT               manifest gains {"floor": {p: s}, "stage": {p: s}}
                         in ONE atomic write — the floor advance and the
                         stage record land together, so pending runs can
                         never be applied onto a base that already absorbed
                         them (the double-apply window)
    rename               each staged file os.replace'd into place
    clear                absorbed run files removed; manifest rewritten
                         without the stage record

    crash before COMMIT  -> staged files without a record: deleted (base +
                            runs intact — nothing happened)
    crash after  COMMIT  -> recovery finishes the renames for staged files
                            still present, deletes runs <= floor, clears
                            the record

The module also owns the named **crash injection points** the recovery test
matrix SIGKILLs a subprocess at (``tests/test_torch_crash_recovery.py``); the
hook is a no-op unless a test installs one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from ..core.storage import (
    DELTA_JOURNAL_PREFIX,
    DELTA_MANIFEST,
    DELTA_RUN_PREFIX,
    DELTA_STAGE_DIR,
    _load_npz_bytes,
    _save_npz_bytes,
)

__all__ = [
    "CRASH_POINTS",
    "RecoveryReport",
    "crashpoint",
    "encode_journal",
    "journal_name",
    "recover",
    "set_crash_hook",
    "stage_rel_name",
]

#: Every named injection point, in protocol order.  The matrix test kills a
#: subprocess at each one and asserts the reopened store is bitwise either
#: the pre-operation or the post-operation oracle — never a mix.
CRASH_POINTS = (
    "publish.first_run",       # first run file durable, rest missing
    "publish.runs_written",    # all run files durable, no journal yet
    "publish.journal_written", # journal durable, manifest not flipped
    "publish.committed",       # manifest flipped, metadata not yet written
    "publish.meta_written",    # metadata durable, journal not yet cleared
    "compact.staged",          # staged containers durable, manifest not flipped
    "compact.flipped",         # manifest flipped, renames pending
    "compact.csr_renamed",     # csr renamed into place, ell rename pending
    "compact.renamed",         # both renamed, run files / record not cleared
)

_crash_hook: Optional[Callable[[str], None]] = None


def set_crash_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with ``None``) the crash-injection hook.
    Test-only; production code never sets it."""
    global _crash_hook
    _crash_hook = hook


def crashpoint(name: str) -> None:
    """Invoke the injection hook, if any.  The matrix driver's hook
    SIGKILLs the process here — simulating a crash with the files exactly
    as the protocol left them at this point."""
    if _crash_hook is not None:
        _crash_hook(name)


def journal_name(seq: int) -> str:
    return f"{DELTA_JOURNAL_PREFIX}{seq:07d}.npz"


def stage_rel_name(base_name: str) -> str:
    """Store-relative path of ``base_name`` inside the staging dir."""
    return f"{DELTA_STAGE_DIR}/{base_name}"


def encode_journal(meta, vids: np.ndarray, num_edges: int) -> bytes:
    """Metadata journal payload: ABSOLUTE post-publish degree rows for the
    touched vertex ids plus the new edge count.  Absolute (not deltas) so
    replay is idempotent — recovery may run after the metadata already
    landed, or itself crash mid-replay and run again."""
    vids = np.asarray(vids, dtype=np.int64)
    return _save_npz_bytes(
        vids=vids,
        in_deg=np.asarray(meta.in_deg)[vids],
        out_deg=np.asarray(meta.out_deg)[vids],
        num_edges=np.array([int(num_edges)], dtype=np.int64),
    )


@dataclasses.dataclass
class RecoveryReport:
    """What one recovery pass did (informational; tests assert on it)."""

    journal_replayed: bool = False
    stage_renames_finished: int = 0
    stage_files_discarded: int = 0
    orphan_runs_removed: int = 0
    orphan_journals_removed: int = 0

    @property
    def acted(self) -> bool:
        return bool(
            self.journal_replayed
            or self.stage_renames_finished
            or self.stage_files_discarded
            or self.orphan_runs_removed
            or self.orphan_journals_removed
        )


def recover(overlay) -> RecoveryReport:
    """Run the recovery state machine for ``overlay``'s store and populate
    the overlay's in-memory state (version, floors, registered runs).

    Called from ``DeltaOverlay.__init__`` — i.e. once per store open, before
    any engine can read.  Idempotent: recovering an already-clean store is
    a no-op, and recovery itself crashing at any point leaves a state a
    second recovery completes.
    """
    store = overlay.store
    rep = RecoveryReport()

    man: Dict = {}
    if store.exists(DELTA_MANIFEST):
        man = json.loads(store.read_bytes(DELTA_MANIFEST))
    overlay.version = int(man.get("version", 0))
    overlay._floor = {int(p): int(s) for p, s in man.get("floor", {}).items()}
    journal_seq = man.get("journal")
    stage = {int(p): int(s) for p, s in man.get("stage", {}).items()}

    # -- 1. committed compaction flips: finish the renames ----------------
    # The stage record in the manifest IS the commit; the base files on
    # disk may be any prefix of {csr renamed, ell renamed}.  Finish what
    # remains; a staged file already renamed is simply absent here.
    stage_dir = store._path(DELTA_STAGE_DIR)
    staged_files = set(os.listdir(stage_dir)) if os.path.isdir(stage_dir) else set()
    for p in sorted(stage):
        for fmt in ("csr", "ell"):
            base = store.shard_name(p, fmt)
            if base in staged_files:
                os.replace(os.path.join(stage_dir, base), store._path(base))
                staged_files.discard(base)
                rep.stage_renames_finished += 1

    # -- 2. uncommitted stage leftovers: discard ---------------------------
    # No record in the manifest -> the compaction never committed; the old
    # base + its pending runs are the truth.  (Includes .tmp scraps from a
    # write that died mid-flight.)
    for f in staged_files:
        try:
            os.remove(os.path.join(stage_dir, f))
            rep.stage_files_discarded += 1
        except OSError:
            pass

    # -- 3. committed publish with unapplied metadata: replay the journal --
    if journal_seq is not None:
        jn = journal_name(int(journal_seq))
        if store.exists(jn):
            z = _load_npz_bytes(store.read_bytes(jn))
            meta = store.read_meta()
            vids = z["vids"]
            meta.in_deg[vids] = z["in_deg"]
            meta.out_deg[vids] = z["out_deg"]
            meta.num_edges = int(z["num_edges"][0])
            store.write_meta(meta)
            rep.journal_replayed = True
        # a referenced-but-missing journal means the clear itself was
        # interrupted after the file removal: metadata already durable

    # -- 4. run files: register published ones, delete orphans -------------
    # seq > version: the publish never committed.  seq <= floor: absorbed
    # by a committed compaction whose cleanup was interrupted.
    for f in sorted(os.listdir(store.root)):
        if not (f.startswith(DELTA_RUN_PREFIX) and f.endswith(".npz")):
            continue
        stem = f[len(DELTA_RUN_PREFIX):-4]
        try:
            p_s, seq_s = stem.split("_")
            p, seq = int(p_s), int(seq_s)
        except ValueError:
            continue
        if seq > overlay.version or seq <= overlay._floor.get(p, 0):
            os.remove(store._path(f))
            rep.orphan_runs_removed += 1
            continue
        from .overlay import DeltaRun  # local: avoid import cycle

        run = DeltaRun(p, seq, f, nbytes=store.file_size(f))
        overlay._runs.setdefault(p, []).append(run)
        overlay._last_publish[p] = max(overlay._last_publish.get(p, 0), seq)
    for runs in overlay._runs.values():
        runs.sort(key=lambda r: r.seq)

    # -- 5. clear recovered protocol state from the manifest ---------------
    # Rewrite BEFORE deleting journal files: if we crash in between, the
    # next recovery finds unreferenced journals and deletes them (step 6);
    # the reverse order would leave a manifest referencing a missing file
    # (tolerated above, but needlessly).
    if journal_seq is not None or stage:
        overlay._stage = {}
        overlay._write_manifest()

    # -- 6. unreferenced journal files: delete ------------------------------
    # After step 5 no journal is referenced; any file left is either an
    # uncommitted publish's (its runs were deleted in step 4) or a cleared
    # one whose removal was interrupted.
    for f in sorted(os.listdir(store.root)):
        if f.startswith(DELTA_JOURNAL_PREFIX) and f.endswith(".npz"):
            os.remove(store._path(f))
            rep.orphan_journals_removed += 1

    return rep
