"""Streamed out-of-core ingestion: the paper's 4-step preprocessing as a
bounded-memory external build (GraphMP §II-B, ROADMAP "Out-of-core
ingestion").

:func:`repro_torch.core.sharding.preprocess` materializes and lexsorts the whole
edge list — O(|E|) memory, which contradicts the SEM premise that
|E| >> RAM.  This module rebuilds the same four steps as a **two-pass
external** pipeline over an on-disk edge file:

pass 1 (scan)
    Stream the file in ``chunk_edges``-sized chunks, accumulating in/out
    degrees (the O(|V|) vertex arrays that SEM keeps resident anyway) and
    optionally inferring ``num_vertices``.  Intervals come from the same
    :func:`~repro_torch.core.sharding.compute_intervals` the in-memory path uses,
    on bitwise-identical degree arrays.

pass 2 (scatter + spill)
    Stream the file again; each chunk's edges are routed to their
    destination shard and buffered as packed ``(dst << 32) | src`` int64
    keys.  When the buffered bytes reach ``mem_budget_bytes`` every
    non-empty buffer is sorted and spilled to a per-shard *run* file
    through the store's accounted write channel.

merge (finalize)
    Shards finalize one at a time, in id order: the shard's sorted runs
    are read back and k-way merged (a binary tournament of vectorized
    two-way merges), the merged keys are unpacked into the CSR ``row`` /
    ``col`` arrays, and the shard is written through
    :meth:`ShardStore.write_shard` (which also derives the device ELL
    format).  Peak memory is O(chunk + one shard), never O(|E|).

Bitwise contract (enforced by ``tests/test_torch_ingest.py``): the in-memory
path orders each shard by ``np.lexsort((src, dst))`` — destination-major,
source-minor.  The packed key sorts by exactly that pair (ids are
non-negative int32, so the key order is the lexicographic (dst, src)
order), runs are individually sorted, and merging sorted runs preserves
the order.  Ties are exact duplicate edges, whose ``col`` entries are
indistinguishable — so ``row``/``col`` come out bitwise-identical to
:func:`preprocess` for every chunk size and spill cadence.

Edge-file formats (auto-detected by extension, overridable via ``fmt``):

``bin``
    Raw little-endian int32 ``(src, dst)`` pairs, no header — the densest
    interchange format (8 bytes/edge, the paper's D=8 term exactly).
``text``
    Whitespace-separated ``src dst`` per line; blank lines and ``#``
    comments skipped (SNAP / WebGraph edge-list convention).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import IO, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace
from .sharding import GraphMeta, ShardCSR, compute_intervals

__all__ = [
    "IngestStats",
    "detect_format",
    "write_edge_file",
    "iter_edge_chunks",
    "ingest_edge_file",
    "kway_merge",
    "pack_keys",
    "keys_of_csr",
    "csr_from_keys",
    "route_edges",
]

_TEXT_EXTS = (".txt", ".el", ".tsv", ".edges", ".edgelist")
_KEY_DTYPE = np.dtype("<i8")
_PAIR_DTYPE = np.dtype("<i4")


# --------------------------------------------------------------------------
# Edge-file readers / writers
# --------------------------------------------------------------------------


def detect_format(path: str) -> str:
    """``text`` for known edge-list extensions, ``bin`` otherwise."""
    ext = os.path.splitext(path)[1].lower()
    return "text" if ext in _TEXT_EXTS else "bin"


def write_edge_file(
    path: str,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    fmt: Optional[str] = None,
    chunk_edges: int = 1 << 20,
) -> int:
    """Write an edge file in ``chunk_edges`` slices; returns bytes written.

    Exists so tests/benchmarks can materialize inputs without holding an
    interleaved copy of the whole edge list.
    """
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    fmt = fmt or detect_format(path)
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    total = 0
    with open(path, "wb") as f:
        for lo in range(0, len(src), chunk_edges):
            s = src[lo: lo + chunk_edges]
            d = dst[lo: lo + chunk_edges]
            if fmt == "bin":
                pairs = np.empty((len(s), 2), dtype=_PAIR_DTYPE)
                pairs[:, 0] = s
                pairs[:, 1] = d
                raw = pairs.tobytes()
            elif fmt == "text":
                raw = "".join(
                    f"{int(a)} {int(b)}\n" for a, b in zip(s, d)
                ).encode()
            else:
                raise ValueError(f"unknown edge-file format {fmt!r}")
            f.write(raw)
            total += len(raw)
        if len(src) == 0:
            # still touch the file so an empty graph is ingestable
            pass
    return total


def _iter_bin_chunks(
    f: IO[bytes], chunk_edges: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    pair_bytes = 2 * _PAIR_DTYPE.itemsize
    while True:
        raw = f.read(chunk_edges * pair_bytes)
        if not raw:
            return
        if len(raw) % pair_bytes:
            raise ValueError(
                f"truncated binary edge file: {len(raw) % pair_bytes} "
                f"trailing bytes (not a whole int32 pair)"
            )
        pairs = np.frombuffer(raw, dtype=_PAIR_DTYPE).reshape(-1, 2)
        yield pairs[:, 0], pairs[:, 1]


def _iter_text_chunks(
    f: IO[bytes], chunk_edges: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    srcs: List[int] = []
    dsts: List[int] = []
    for lineno, line in enumerate(f, 1):
        part = line.partition(b"#")[0].split()
        if not part:
            continue
        if len(part) < 2:
            raise ValueError(f"line {lineno}: expected 'src dst', got {line!r}")
        srcs.append(int(part[0]))
        dsts.append(int(part[1]))
        if len(srcs) >= chunk_edges:
            yield np.asarray(srcs, dtype=np.int64), np.asarray(dsts, dtype=np.int64)
            srcs, dsts = [], []
    if srcs:
        yield np.asarray(srcs, dtype=np.int64), np.asarray(dsts, dtype=np.int64)


def iter_edge_chunks(
    path: str,
    *,
    chunk_edges: int = 1 << 20,
    fmt: Optional[str] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(src, dst)`` arrays of at most ``chunk_edges`` edges each.

    The file is read front-to-back with O(chunk) resident bytes; calling it
    twice is the two-pass discipline of the external build.
    """
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    fmt = fmt or detect_format(path)
    with open(path, "rb") as f:
        if fmt == "bin":
            yield from _iter_bin_chunks(f, chunk_edges)
        elif fmt == "text":
            yield from _iter_text_chunks(f, chunk_edges)
        else:
            raise ValueError(f"unknown edge-file format {fmt!r}")


# --------------------------------------------------------------------------
# K-way merge of sorted runs
# --------------------------------------------------------------------------


def _merge_two(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Stable vectorized merge of two sorted arrays (a before b on ties)."""
    if len(a) == 0:
        return b
    if len(b) == 0:
        return a
    out = np.empty(len(a) + len(b), dtype=a.dtype)
    # final position of a[i] = i + (# of b strictly before it); of b[j] =
    # j + (# of a at-or-before it).  Disjoint + exhaustive, hence a merge.
    out[np.arange(len(a)) + np.searchsorted(b, a, side="left")] = a
    out[np.arange(len(b)) + np.searchsorted(a, b, side="right")] = b
    return out


def kway_merge(runs: Sequence[np.ndarray]) -> np.ndarray:
    """Merge k sorted arrays via a binary tournament (ceil(log2 k) rounds).

    Each round halves the number of runs with vectorized two-way merges;
    total work is O(n log k) with no per-element Python overhead.  Because
    every input is sorted and two-way merge preserves sortedness, the
    result is the sorted union — this is why spill order (which edges
    landed in which run) cannot affect the final shard layout.
    """
    runs = [r for r in runs if len(r)]
    if not runs:
        return np.empty(0, dtype=_KEY_DTYPE)
    while len(runs) > 1:
        merged = [
            _merge_two(runs[i], runs[i + 1]) if i + 1 < len(runs) else runs[i]
            for i in range(0, len(runs), 2)
        ]
        runs = merged
    return runs[0]


# --------------------------------------------------------------------------
# The two-pass external build
# --------------------------------------------------------------------------


@dataclasses.dataclass
class IngestStats:
    """What the external build did and what it cost.

    The accounting identity ``store.io.bytes_written == spill_bytes_written
    + shard_bytes_written + meta_bytes_written`` holds on a fresh store —
    every byte the build writes goes through the accounted channel
    (asserted by ``tests/test_torch_ingest.py``).
    """

    num_vertices: int = 0
    num_edges: int = 0
    num_shards: int = 0
    chunks_pass1: int = 0
    chunks_pass2: int = 0
    spills: int = 0  # buffer flushes (each may emit many runs)
    runs: int = 0  # spill run files written
    max_runs_per_shard: int = 0  # merge fan-in upper bound
    spill_bytes_written: int = 0
    spill_bytes_read: int = 0
    shard_bytes_written: int = 0  # final CSR + ELL containers
    meta_bytes_written: int = 0  # property.json + vertexinfo.npz
    peak_buffered_bytes: int = 0  # high-water of the pass-2 scatter buffers
    peak_shard_bytes: int = 0  # largest single-shard merge working set
    stale_shards_removed: int = 0  # re-ingest into a dir with more shards
    orphan_runs_removed: int = 0  # scratch left by a crashed prior ingest
    stale_delta_runs_removed: int = 0  # re-ingest replaces pending deltas
    finalize_workers: int = 1  # concurrent per-shard merge+write workers
    warm_sources_built: int = 0  # shards whose Bloom inputs were deposited
    warm_raw_bytes: int = 0  # container bytes left warm for cache prefill

    @property
    def bytes_written_total(self) -> int:
        return (
            self.spill_bytes_written
            + self.shard_bytes_written
            + self.meta_bytes_written
        )


class _DegreeScan:
    """Pass 1 accumulator: degrees + vertex-count inference.

    Capacity grows geometrically (2x) when ids are inferred, so a file
    whose ids trend upward costs amortized O(V) copying, not O(V·chunks).
    """

    def __init__(self, num_vertices: Optional[int]):
        self.explicit_n = num_vertices
        n = num_vertices or 0
        self.in_deg = np.zeros(n, dtype=np.int64)
        self.out_deg = np.zeros(n, dtype=np.int64)
        self.num_edges = 0
        self._max_id = -1

    def _grow(self, n: int) -> None:
        cap = len(self.in_deg)
        if n > cap:
            new_cap = max(n, 2 * cap)
            pad = np.zeros(new_cap - cap, dtype=np.int64)
            self.in_deg = np.concatenate([self.in_deg, pad])
            self.out_deg = np.concatenate([self.out_deg, pad])

    def add(self, src: np.ndarray, dst: np.ndarray) -> None:
        if len(src) == 0:
            return
        lo = min(int(src.min()), int(dst.min()))
        hi = max(int(src.max()), int(dst.max()))
        if lo < 0:
            raise ValueError(f"negative vertex id {lo} in edge file")
        if self.explicit_n is not None and hi >= self.explicit_n:
            raise ValueError(
                f"vertex id {hi} out of range [0, {self.explicit_n})"
            )
        self._grow(hi + 1)
        self._max_id = max(self._max_id, hi)
        self.in_deg += np.bincount(dst, minlength=len(self.in_deg))
        self.out_deg += np.bincount(src, minlength=len(self.out_deg))
        self.num_edges += len(src)

    @property
    def num_vertices(self) -> int:
        return self.explicit_n if self.explicit_n is not None else self._max_id + 1

    def degrees(self) -> Tuple[np.ndarray, np.ndarray]:
        """The exact-length degree arrays (trims growth over-allocation)."""
        n = self.num_vertices
        if n == len(self.in_deg):
            return self.in_deg, self.out_deg
        return self.in_deg[:n].copy(), self.out_deg[:n].copy()


def pack_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(dst << 32) | src — int64 keys whose ascending order is the
    destination-major (dst, src) lexicographic order for int32 ids."""
    return (dst.astype(np.int64) << 32) | src.astype(np.int64)


_pack_keys = pack_keys  # original (private) name, kept for callers


def keys_of_csr(csr) -> np.ndarray:
    """Packed sorted keys of a destination-sorted CSR shard — the exact
    inverse of :func:`csr_from_keys` (shards store edges in ascending key
    order, so expanding rows back to (dst, src) pairs yields sorted keys).
    """
    rows = csr.v1 - csr.v0
    dst_local = np.repeat(np.arange(rows, dtype=np.int64), np.diff(csr.row))
    return ((dst_local + csr.v0) << 32) | csr.col.astype(np.int64)


def csr_from_keys(shard_id: int, v0: int, v1: int, keys: np.ndarray):
    """Build the ShardCSR of interval ``[v0, v1)`` from sorted packed keys.

    Single point of truth for the key→CSR transform: the streamed ingest
    finalize, the delta overlay decode and the recompactor all call it, so
    a logical shard decodes bitwise-identically on every path.
    """
    dst_local = (keys >> 32) - v0
    col = (keys & 0xFFFFFFFF).astype(np.int32)
    counts = np.bincount(dst_local, minlength=v1 - v0)
    row = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return ShardCSR(shard_id=shard_id, v0=v0, v1=v1, row=row, col=col)


def route_edges(
    intervals: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> Iterator[Tuple[int, np.ndarray]]:
    """Scatter one edge chunk to destination shards: yields ``(p, keys)``
    per touched shard (keys packed, file order preserved — NOT sorted).
    The pass-2 spill path and the delta EdgeLog share this routing."""
    if len(src) == 0:
        return
    keys = pack_keys(src, dst)
    shard_of = np.searchsorted(intervals, dst, side="right") - 1
    order = np.argsort(shard_of, kind="stable")
    keys = keys[order]
    shard_sorted = shard_of[order]
    touched, starts = np.unique(shard_sorted, return_index=True)
    stops = np.append(starts[1:], len(keys))
    for p, lo, hi in zip(touched, starts, stops):
        yield int(p), keys[lo:hi]


def _run_name(shard_id: int, run: int) -> str:
    return f"ingest_run_{shard_id:05d}_{run:05d}.bin"


def ingest_edge_file(
    store,
    path: str,
    *,
    edges_per_shard: Optional[int] = None,
    num_shards: Optional[int] = None,
    num_vertices: Optional[int] = None,
    chunk_edges: int = 1 << 20,
    mem_budget_bytes: int = 64 << 20,
    window: int = 1 << 14,
    k: int = 128,
    tr: int = 8,
    fmt: Optional[str] = None,
    finalize_workers: int = 1,
    warm_sources: bool = True,
    warm_bytes: int = 0,
) -> Tuple[GraphMeta, IngestStats]:
    """Stream ``path`` into ``store`` with O(chunk + one shard) peak memory.

    ``store`` is a :class:`~repro_torch.core.storage.ShardStore`; spill runs and
    final shards all go through its accounted I/O channel.  Returns the
    same ``GraphMeta`` (bitwise) that in-memory ``preprocess`` would have
    produced, plus the build's :class:`IngestStats`.

    ``finalize_workers``: per-shard k-way merges are independent, so the
    finalize step can run them on a thread pool (0 = one worker per core,
    capped at 4).  Peak memory grows to O(chunk + workers * shard); the
    default of 1 preserves the strict single-shard bound.  Output and byte
    accounting are identical for every worker count — each shard's merge is
    self-contained and its bytes are measured per shard, not per interval
    of the global counters.

    The three steps run under ``ingest.scan``, ``ingest.scatter`` and
    ``ingest.finalize`` trace spans (their seconds, when a tracer is on).

    Warmup: ``warm_sources`` deposits each shard's unique
    source ids on the store while the merged arrays are in memory, so
    engine boot builds Bloom filters without re-reading every shard;
    ``warm_bytes > 0`` additionally keeps up to that many container bytes
    for cache prefill at boot.
    """
    if chunk_edges < 1:
        raise ValueError("chunk_edges must be >= 1")
    if mem_budget_bytes < _KEY_DTYPE.itemsize:
        raise ValueError("mem_budget_bytes must hold at least one edge key")
    if (num_shards is None) == (edges_per_shard is None):
        # fail in milliseconds, not after a full pass over a huge file
        raise ValueError("specify exactly one of num_shards / edges_per_shard")
    if finalize_workers < 0:
        raise ValueError("finalize_workers must be >= 0 (0 = auto)")
    if finalize_workers == 0:
        finalize_workers = min(4, os.cpu_count() or 1)
    fmt = fmt or detect_format(path)
    stats = IngestStats(finalize_workers=finalize_workers)

    # orphaned scratch from a previously crashed/interrupted ingest, and
    # pending delta runs from the store's previous life — a full re-ingest
    # replaces the whole logical graph, so leftover mutations are stale
    for f in os.listdir(store.root):
        if f.startswith("ingest_run_") and f.endswith(".bin"):
            os.remove(store._path(f))
            stats.orphan_runs_removed += 1
        elif (
            f.startswith(("delta_run_", "delta_journal_"))
            or f == "delta_manifest.json"
        ):
            os.remove(store._path(f))
            stats.stale_delta_runs_removed += 1
        elif f == "delta_stage" and os.path.isdir(store._path(f)):
            import shutil

            shutil.rmtree(store._path(f))
            stats.stale_delta_runs_removed += 1
    if getattr(store, "delta", None) is not None:
        store.delta = None  # state referred to the replaced graph

    # ---- pass 1: degree scan -------------------------------------------
    scan = _DegreeScan(num_vertices)
    with trace.span("ingest.scan") as sp:
        for src, dst in iter_edge_chunks(path, chunk_edges=chunk_edges, fmt=fmt):
            scan.add(src, dst)
            stats.chunks_pass1 += 1
        sp.set(chunks=stats.chunks_pass1, edges=scan.num_edges)
    n = scan.num_vertices
    in_deg, out_deg = scan.degrees()
    intervals = compute_intervals(
        in_deg, num_shards=num_shards, edges_per_shard=edges_per_shard
    )
    P = len(intervals) - 1
    stats.num_vertices = n
    stats.num_edges = scan.num_edges
    stats.num_shards = P

    # ---- pass 2: scatter + spill ---------------------------------------
    buffers: List[List[np.ndarray]] = [[] for _ in range(P)]
    buffered_bytes = 0
    run_names: List[List[str]] = [[] for _ in range(P)]

    def spill() -> None:
        nonlocal buffered_bytes
        if buffered_bytes == 0:
            return
        stats.spills += 1
        for p in range(P):
            if not buffers[p]:
                continue
            run = np.sort(np.concatenate(buffers[p]))
            name = _run_name(p, len(run_names[p]))
            store.write_bytes(name, run.tobytes())
            run_names[p].append(name)
            stats.runs += 1
            stats.spill_bytes_written += run.nbytes
            buffers[p] = []
        buffered_bytes = 0

    with trace.span("ingest.scatter") as sp:
        for src, dst in iter_edge_chunks(path, chunk_edges=chunk_edges, fmt=fmt):
            stats.chunks_pass2 += 1
            nbytes_chunk = 0
            for p, keys in route_edges(intervals, src, dst):
                buffers[p].append(keys)
                nbytes_chunk += keys.nbytes
            buffered_bytes += nbytes_chunk
            stats.peak_buffered_bytes = max(stats.peak_buffered_bytes,
                                            buffered_bytes)
            if buffered_bytes >= mem_budget_bytes:
                spill()
        sp.set(chunks=stats.chunks_pass2, spills=stats.spills, runs=stats.runs)

    # ---- merge + finalize: shards are independent, so ``finalize_workers``
    # of them merge+write concurrently (stats mutated under one lock; byte
    # counts measured per shard so parallelism cannot skew them) ----------
    stats_lock = threading.Lock()

    def _finalize_shard(p: int) -> None:
        v0, v1 = int(intervals[p]), int(intervals[p + 1])
        runs = []
        spill_read = 0
        for name in run_names[p]:
            raw = store.read_bytes(name)
            spill_read += len(raw)
            runs.append(np.frombuffer(raw, dtype=_KEY_DTYPE))
        if buffers[p]:  # tail edges never spilled: one in-memory run
            runs.append(np.sort(np.concatenate(buffers[p])))
            buffers[p] = []
        merged = kway_merge(runs)
        n_runs = len(runs)
        del runs
        shard = csr_from_keys(p, v0, v1, merged)
        working_set = merged.nbytes + shard.nbytes
        del merged
        capture = {} if warm_bytes > 0 else None
        store.write_shard(
            shard, num_vertices=n, window=window, k=k, tr=tr, capture=capture
        )
        written = store.file_size(store.shard_name(p, "csr")) + store.file_size(
            store.shard_name(p, "ell")
        )
        for name in run_names[p]:  # spill runs are scratch, not the store
            os.remove(store._path(name))
        run_names[p] = []
        warmed_srcs = 0
        if warm_sources:
            store.set_warm_sources(p, np.unique(shard.col).astype(np.int64))
            warmed_srcs = 1
        warm_kept = 0
        if capture is not None:
            for (cp, cfmt), raw in sorted(capture.items(), key=lambda kv: kv[0][1]):
                if store.warm_raw_bytes_total() + len(raw) <= warm_bytes:
                    store.add_warm_raw(cp, cfmt, raw)
                    warm_kept += len(raw)
        with stats_lock:
            stats.spill_bytes_read += spill_read
            stats.max_runs_per_shard = max(stats.max_runs_per_shard, n_runs)
            stats.peak_shard_bytes = max(stats.peak_shard_bytes, working_set)
            stats.shard_bytes_written += written
            stats.warm_sources_built += warmed_srcs
            stats.warm_raw_bytes += warm_kept

    with trace.span("ingest.finalize", shards=P, workers=finalize_workers):
        if finalize_workers > 1 and P > 1:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(finalize_workers, P),
                thread_name_prefix="ingest-finalize",
            ) as pool:
                for _ in pool.map(_finalize_shard, range(P)):
                    pass  # re-raises worker exceptions
        else:
            for p in range(P):
                _finalize_shard(p)

    # ---- stale shards from a previous (larger) ingest ------------------
    p = P
    while store.exists(store.shard_name(p, "csr")) or store.exists(
        store.shard_name(p, "ell")
    ):
        for f in (store.shard_name(p, "csr"), store.shard_name(p, "ell")):
            if store.exists(f):
                os.remove(store._path(f))
        store.invalidate_shard(p)
        stats.stale_shards_removed += 1
        p += 1

    # ---- metadata last: a dir without property.json is not bootable ----
    meta = GraphMeta(
        num_vertices=n,
        num_edges=scan.num_edges,
        num_shards=P,
        intervals=intervals,
        in_deg=in_deg,
        out_deg=out_deg,
    )
    io0 = store.io.snapshot()
    store.write_meta(meta, ell_params={"window": window, "k": k, "tr": tr})
    stats.meta_bytes_written += (store.io - io0).bytes_written
    return meta, stats
