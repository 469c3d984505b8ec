"""On-disk shard storage with byte-accurate I/O accounting.

The paper's performance argument is an I/O argument (Table II): VSW reads
``θ·D·|E|`` bytes per iteration and writes nothing.  :class:`ShardStore`
persists shards as uncompressed ``.npz`` containers and counts every byte
that crosses the disk boundary.

The layout is the reference package's, byte for byte, so a store written
by either package opens in the other.  Two parts of the reference store
are not carried yet: the streamed external build (:meth:`ShardStore.ingest`
raises) and live mutations — a store that carries delta files refuses to
open rather than boot without them (ROADMAP Queue 1, items 4 and 6).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace
from .csr import EllShard, csr_to_ell
from .sharding import GraphMeta, ShardCSR

__all__ = ["IOStats", "ShardStore"]

#: files and directories of the reference's live-mutation layer; a store
#: holding any of them has pending mutations this package cannot apply.
DELTA_PREFIXES = ("delta_run_", "delta_journal_")
DELTA_MANIFEST = "delta_manifest.json"
DELTA_STAGE_DIR = "delta_stage"


@dataclasses.dataclass
class IOStats:
    """Byte/operation counters for one storage channel."""

    bytes_read: int = 0
    bytes_written: int = 0
    reads: int = 0
    writes: int = 0

    def snapshot(self) -> "IOStats":
        return IOStats(self.bytes_read, self.bytes_written, self.reads, self.writes)

    def __sub__(self, other: "IOStats") -> "IOStats":
        return IOStats(
            self.bytes_read - other.bytes_read,
            self.bytes_written - other.bytes_written,
            self.reads - other.reads,
            self.writes - other.writes,
        )


def _save_npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npz_bytes(raw: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


class ShardStore:
    """Persist/load graph shards + metadata with I/O accounting.

    Layout (paper §II-B: edge shards + property file + vertex info file)::

        <root>/property.json          graph-level metadata
        <root>/vertexinfo.npz         in/out degree arrays
        <root>/shard_00042.csr.npz    CSR (row/col/interval)
        <root>/shard_00042.ell.npz    derived windowed ELL arrays
    """

    def __init__(self, root: str, *, emulate_bw: Optional[float] = None):
        """``emulate_bw``: optional bytes/s throttle, so reads and writes
        cost wall time proportional to the bytes moved (the paper's testbed
        is HDD RAID at about 150 MB/s)."""
        self.root = root
        os.makedirs(root, exist_ok=True)
        pending = [
            f for f in os.listdir(root)
            if f.startswith(DELTA_PREFIXES) or f in (DELTA_MANIFEST,
                                                     DELTA_STAGE_DIR)
        ]
        if pending:
            raise NotImplementedError(
                f"store {root!r} carries live-mutation files "
                f"({sorted(pending)[:3]}...); applying them is ROADMAP "
                f"Queue 1 item 6, not ported yet")
        self.io = IOStats()
        self.emulate_bw = emulate_bw
        # The prefetching loader reads from background threads; every
        # IOStats mutation holds this lock so snapshot deltas cannot drift.
        self._io_lock = threading.Lock()
        # The emulated disk is ONE shared channel: concurrent reads queue
        # for bandwidth rather than each sleeping independently.
        self._throttle_lock = threading.Lock()
        self._channel_free_at = 0.0
        # Overwriting a shard that a live engine has cached must not leave
        # stale copies behind: consumers register a hook, and write_shard
        # calls it with the shard id when an EXISTING shard is replaced.
        # The generation counter closes the read->invalidate->put race.
        self._invalidation_hooks: List[Callable[[int], None]] = []
        self._shard_gen: Dict[int, int] = {}
        self._gen_lock = threading.Lock()
        self._ell_params: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------------ raw
    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _throttle(self, nbytes: int) -> None:
        if self.emulate_bw:
            with self._throttle_lock:
                now = time.monotonic()
                start = max(now, self._channel_free_at)
                self._channel_free_at = start + nbytes / self.emulate_bw
                wait = self._channel_free_at - now
            if wait > 0:
                time.sleep(wait)

    def read_bytes(self, name: str) -> bytes:
        with trace.span("store.read", key=name) as sp:
            with open(self._path(name), "rb") as f:
                raw = f.read()
            sp.set(bytes=len(raw))
            with self._io_lock:
                self.io.bytes_read += len(raw)
                self.io.reads += 1
            self._throttle(len(raw))
        return raw

    def write_bytes(self, name: str, raw: bytes) -> None:
        with trace.span("store.write", key=name, bytes=len(raw)):
            tmp = self._path(name) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, self._path(name))  # atomic: no torn shard files
            with self._io_lock:
                self.io.bytes_written += len(raw)
                self.io.writes += 1
            self._throttle(len(raw))

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    # ------------------------------------------------------- invalidation
    def register_invalidation(self, hook: Callable[[int], None]) -> None:
        """Call ``hook(shard_id)`` whenever an existing shard is replaced,
        so cached raw bytes and decoded/device copies can be dropped."""
        self._invalidation_hooks.append(hook)

    def unregister_invalidation(self, hook: Callable[[int], None]) -> None:
        try:
            self._invalidation_hooks.remove(hook)
        except ValueError:
            pass

    def shard_generation(self, p: int) -> int:
        """Monotone per-shard counter, bumped on every overwrite.  Loaders
        snapshot it before a read and compare after inserting into a
        cache: a moved generation means the bytes may be stale."""
        with self._gen_lock:
            return self._shard_gen.get(p, 0)

    def invalidate_shard(self, p: int) -> None:
        """Bump the shard's generation and fire the hooks."""
        with self._gen_lock:
            self._shard_gen[p] = self._shard_gen.get(p, 0) + 1
        for hook in list(self._invalidation_hooks):
            hook(p)

    def file_size(self, name: str) -> int:
        return os.path.getsize(self._path(name))

    # ------------------------------------------------------------- metadata
    def write_meta(self, meta: GraphMeta) -> None:
        prop = {
            "num_vertices": meta.num_vertices,
            "num_edges": meta.num_edges,
            "num_shards": meta.num_shards,
            "intervals": meta.intervals.tolist(),
        }
        if self._ell_params is None and self.exists("property.json"):
            # a fresh process rewriting the metadata of an existing store
            # carries the persisted ELL block forward
            old = json.loads(self.read_bytes("property.json"))
            if "ell" in old:
                self._ell_params = {k: int(v) for k, v in old["ell"].items()}
        if self._ell_params is not None:
            prop["ell"] = {k: int(self._ell_params[k])
                           for k in ("window", "k", "tr")}
        self.write_bytes("property.json", json.dumps(prop).encode())
        self.write_bytes(
            "vertexinfo.npz",
            _save_npz_bytes(in_deg=meta.in_deg, out_deg=meta.out_deg),
        )

    def read_meta(self) -> GraphMeta:
        prop = json.loads(self.read_bytes("property.json"))
        vi = _load_npz_bytes(self.read_bytes("vertexinfo.npz"))
        return GraphMeta(
            num_vertices=prop["num_vertices"],
            num_edges=prop["num_edges"],
            num_shards=prop["num_shards"],
            intervals=np.asarray(prop["intervals"], dtype=np.int64),
            in_deg=vi["in_deg"],
            out_deg=vi["out_deg"],
        )

    # --------------------------------------------------------------- shards
    #
    # CSR (the paper's disk format) and ELL (the device format) live in
    # SEPARATE files so an engine reads only the representation its backend
    # consumes.  ELL validity masks are bit-packed on disk (8x smaller);
    # unpacking is host decode cost, like decompression.

    @staticmethod
    def shard_name(p: int, fmt: str = "csr") -> str:
        return f"shard_{p:05d}.{fmt}.npz"

    def encode_shard(
        self,
        shard: ShardCSR,
        *,
        num_vertices: int,
        window: int,
        k: int,
        tr: int,
    ) -> Tuple[bytes, bytes, EllShard]:
        """Encode one shard's CSR + derived ELL container bytes."""
        ell = csr_to_ell(shard, num_vertices, window=window, k=k, tr=tr)
        csr_raw = _save_npz_bytes(
            interval=np.array([shard.v0, shard.v1], dtype=np.int64),
            row=shard.row,
            col=shard.col,
        )
        ell_raw = _save_npz_bytes(
            interval=np.array([shard.v0, shard.v1], dtype=np.int64),
            ell_idx=ell.ell_idx,
            mask_bits=np.packbits(ell.ell_mask, axis=None),
            seg=ell.seg,
            tile_window=ell.tile_window,
            ell_meta=np.array(
                [num_vertices, window, k, tr, ell.nnz, ell.n_ell], dtype=np.int64
            ),
        )
        return csr_raw, ell_raw, ell

    def write_shard(
        self,
        shard: ShardCSR,
        *,
        num_vertices: int,
        window: int,
        k: int,
        tr: int,
    ) -> EllShard:
        """Persist CSR + derived device (ELL) format; returns the EllShard.

        Overwriting an existing shard id bumps the shard's generation and
        notifies every registered invalidation hook AFTER the new bytes
        land.
        """
        overwrite = self.exists(self.shard_name(shard.shard_id, "csr")) or self.exists(
            self.shard_name(shard.shard_id, "ell")
        )
        csr_raw, ell_raw, ell = self.encode_shard(
            shard, num_vertices=num_vertices, window=window, k=k, tr=tr
        )
        self.write_bytes(self.shard_name(shard.shard_id, "csr"), csr_raw)
        self.write_bytes(self.shard_name(shard.shard_id, "ell"), ell_raw)
        if self._ell_params is None:
            self._ell_params = {"window": window, "k": k, "tr": tr}
        if overwrite:
            self.invalidate_shard(shard.shard_id)
        return ell

    def shard_bytes(self, p: int, fmt: str = "csr") -> bytes:
        """Read the raw (uncompressed) shard container from disk."""
        return self.read_bytes(self.shard_name(p, fmt))

    def shard_bytes_bulk(self, ps: Sequence[int], fmt: str = "csr") -> Dict[int, bytes]:
        """Read several shard containers in one call."""
        return {p: self.shard_bytes(p, fmt) for p in ps}

    @staticmethod
    def decode_csr(p: int, raw: bytes) -> ShardCSR:
        z = _load_npz_bytes(raw)
        v0, v1 = (int(x) for x in z["interval"])
        return ShardCSR(shard_id=p, v0=v0, v1=v1, row=z["row"], col=z["col"])

    @staticmethod
    def decode_ell(p: int, raw: bytes) -> EllShard:
        z = _load_npz_bytes(raw)
        v0, v1 = (int(x) for x in z["interval"])
        nv, window, k, tr, nnz, n_ell = (int(x) for x in z["ell_meta"])
        mask = np.unpackbits(z["mask_bits"], count=n_ell * k).astype(bool)
        return EllShard(
            shard_id=p, v0=v0, v1=v1, num_vertices=nv, window=window, k=k, tr=tr,
            ell_idx=z["ell_idx"], ell_mask=mask.reshape(n_ell, k), seg=z["seg"],
            tile_window=z["tile_window"], nnz=nnz,
        )

    def load_shard(self, p: int, fmt: str = "csr"):
        """Read + decode one shard."""
        raw = self.shard_bytes(p, fmt)
        if fmt == "csr":
            return self.decode_csr(p, raw)
        return self.decode_ell(p, raw)

    def ingest(self, path: str, **kwargs):
        """The streamed two-pass external build of the reference store."""
        raise NotImplementedError(
            "ShardStore.ingest is ROADMAP Queue 1 item 4, not ported yet; "
            "build a store with VSWEngine.from_graph or the reference package")
