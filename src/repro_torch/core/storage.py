"""On-disk shard storage with byte-accurate I/O accounting.

The paper's performance argument is an I/O argument (Table II): VSW reads
``θ·D·|E|`` bytes per iteration and writes nothing.  :class:`ShardStore`
persists shards as uncompressed ``.npz`` containers and counts every byte
that crosses the disk boundary.

The layout is the reference package's, byte for byte, so a store written
by either package opens in the other — delta runs, journals, the manifest
and the compaction stage included (:mod:`repro_torch.delta`).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
import zipfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace
from .csr import EllShard, csr_to_ell
from .sharding import GraphMeta, ShardCSR

__all__ = ["IOStats", "ShardStore"]

#: npz container keys of one delta run file (repro_torch.delta): destination-
#: sorted ``(dst<<32|src)`` insert keys plus unique tombstone keys.
DELTA_RUN_PREFIX = "delta_run_"
DELTA_MANIFEST = "delta_manifest.json"
#: per-publish metadata journal (repro_torch.delta.recovery): ABSOLUTE post-
#: publish degree rows + edge count, written before the manifest commit so
#: recovery can replay the metadata of a committed publish idempotently.
DELTA_JOURNAL_PREFIX = "delta_journal_"
#: staging directory for recompaction's staged-rename swap: new base
#: containers land here first, the manifest flips, then each file is
#: renamed into place (recovery finishes or discards, DESIGN.md §12).
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


class _BufferFile(io.RawIOBase):
    """A read-only, seekable file over any buffer, for ``zipfile``'s reads
    of a container's directory: ``io.BytesIO`` would copy a buffer that is
    not ``bytes`` whole."""

    def __init__(self, buf):
        self._mv = memoryview(buf).cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos,
                io.SEEK_END: len(self._mv)}[whence]
        self._pos = max(0, base + pos)
        return self._pos

    def readinto(self, b) -> int:
        n = max(0, min(len(b), len(self._mv) - self._pos))
        b[:n] = self._mv[self._pos:self._pos + n]
        self._pos += n
        return n


def _npy_member(data: memoryview) -> Optional[np.ndarray]:
    """The array of one stored ``.npy`` member: a view of ``data`` where
    that is writable, else a copy; ``None`` for a header version this
    parser leaves to ``np.load``."""
    f = io.BytesIO(data[:12].tobytes())
    version = np.lib.format.read_magic(f)
    if version not in ((1, 0), (2, 0)):
        return None
    width = 2 if version == (1, 0) else 4
    start = 8 + width + int.from_bytes(data[8:8 + width], "little")
    f = io.BytesIO(data[:start].tobytes())
    np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    if dtype.hasobject:
        raise ValueError("Object arrays cannot be loaded when allow_pickle=False")
    count = int(np.prod(shape, dtype=np.int64))
    flat = np.frombuffer(data, dtype=dtype, count=count, offset=start)
    arr = flat.reshape(shape[::-1]).T if fortran else flat.reshape(shape)
    return arr if arr.flags.writeable else arr.copy(order="K")


def _load_npz_bytes(raw) -> Dict[str, np.ndarray]:
    """The arrays of an ``np.savez`` container, as ``np.load`` gives them.

    A stored (uncompressed) member is checked against its CRC-32 and then
    taken in one call, so a 200 MB shard costs a few C calls rather than
    ``np.load``'s loop over 256 KiB chunks, each a read, a CRC update and
    a copy that take and give back the interpreter lock.  From a writable
    buffer (:meth:`ShardStore.shard_bytes`) the arrays are views of it,
    and copies from anything else (``bytes``), as ``np.load``'s are; a
    view shares the buffer, and with it a byte cache's entry, so the
    decoded arrays are read and never written.  Any other member falls
    back to ``np.load``."""
    mv = memoryview(raw).cast("B")
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(_BufferFile(mv)) as zf:
        infos = zf.infolist()
    for zi in infos:
        off = zi.header_offset
        arr = None
        if (zi.filename.endswith(".npy") and zi.compress_type == zipfile.ZIP_STORED
                and not zi.flag_bits & 0x1 and mv[off:off + 4] == b"PK\x03\x04"):
            start = (off + 30 + int.from_bytes(mv[off + 26:off + 28], "little")
                     + int.from_bytes(mv[off + 28:off + 30], "little"))
            data = mv[start:start + zi.file_size]
            if zlib.crc32(data) != zi.CRC:
                raise zipfile.BadZipFile(f"Bad CRC-32 for file {zi.filename!r}")
            arr = _npy_member(data)
        if arr is None:
            with np.load(_BufferFile(mv)) as z:
                return {k: z[k] for k in z.files}
        out[zi.filename[:-4]] = arr
    return out


class ShardStore:
    """Persist/load graph shards + metadata with I/O accounting.

    Layout (paper §II-B: edge shards + property file + vertex info file)::

        <root>/property.json          graph-level metadata
        <root>/vertexinfo.npz         in/out degree arrays
        <root>/shard_00042.csr.npz    CSR (row/col/interval)
        <root>/shard_00042.ell.npz    derived windowed ELL arrays
        <root>/aux_<name>.npz         engine-specific extra data (baselines)
    """

    def __init__(self, root: str, *, emulate_bw: Optional[float] = None):
        """``emulate_bw``: optional bytes/s throttle, so reads and writes
        cost wall time proportional to the bytes moved (the paper's testbed
        is HDD RAID at about 150 MB/s)."""
        self.root = root
        os.makedirs(root, exist_ok=True)
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
        # Ingest-time warmup: the finalize step of ``ingest`` already holds
        # each shard's CSR arrays, so it deposits per-shard unique-source
        # arrays (Bloom filter inputs) and optionally raw container bytes
        # here.  Engine boot consumes them instead of re-reading every
        # shard (``ShardScheduler.build_filters``).  In-memory only.
        self._warm_lock = threading.Lock()
        self._warm_sources: Dict[int, np.ndarray] = {}
        self._warm_raw: Dict[Tuple[int, str], bytes] = {}
        # Live-mutation state (repro_torch.delta): a DeltaOverlay tracking
        # pending per-shard delta runs.  Attached lazily — on first EdgeLog
        # use, or at open time when delta run files / a manifest are found
        # on disk (a store carrying unabsorbed mutations boots with them).
        self.delta = None
        if (
            os.path.exists(os.path.join(root, DELTA_MANIFEST))
            or os.path.isdir(os.path.join(root, DELTA_STAGE_DIR))
            or any(
                f.startswith((DELTA_RUN_PREFIX, DELTA_JOURNAL_PREFIX))
                for f in os.listdir(root)
            )
        ):
            self.ensure_delta()

    def ensure_delta(self):
        """Attach (or return) this store's :class:`~repro_torch.delta.
        DeltaOverlay`, recovering any published delta runs already on disk."""
        if self.delta is None:
            from ..delta.overlay import DeltaOverlay  # lazy: avoid a cycle

            self.delta = DeltaOverlay(self)
        return self.delta

    # ------------------------------------------------------- ingest warmup
    def set_warm_sources(self, p: int, srcs: np.ndarray) -> None:
        with self._warm_lock:
            self._warm_sources[p] = srcs

    def warm_sources(self, p: int) -> Optional[np.ndarray]:
        """Unique source ids of shard ``p`` if a producer left them warm."""
        with self._warm_lock:
            return self._warm_sources.get(p)

    def add_warm_raw(self, p: int, fmt: str, raw: bytes) -> None:
        with self._warm_lock:
            self._warm_raw[(p, fmt)] = raw

    def warm_raw(self, p: int, fmt: str) -> Optional[bytes]:
        with self._warm_lock:
            return self._warm_raw.get((p, fmt))

    def warm_raw_bytes_total(self) -> int:
        with self._warm_lock:
            return sum(len(b) for b in self._warm_raw.values())

    def _drop_warm(self, p: int) -> None:
        with self._warm_lock:
            self._warm_sources.pop(p, None)
            self._warm_raw.pop((p, "csr"), None)
            self._warm_raw.pop((p, "ell"), None)

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
        return self._read(name, lambda f: f.read())

    def _read(self, name: str, read):
        with trace.span("store.read", key=name) as sp:
            with open(self._path(name), "rb") as f:
                raw = read(f)
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
        """Call ``hook(shard_id)`` whenever an existing shard is replaced
        (re-ingest, overwrite, compaction) or removed, or a delta publish
        changes it, so cached raw bytes and decoded/device copies can be
        dropped."""
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

    def invalidate_shard(self, p: int, *, drop_warm: bool = True) -> None:
        """Bump the shard's generation and fire the hooks.  ``drop_warm=False``
        is the delta-publish case: base bytes are unchanged (warm base-source
        arrays stay valid) but decoded/cached/device copies are stale."""
        if drop_warm:
            self._drop_warm(p)  # producers re-deposit after a rewrite
        with self._gen_lock:
            self._shard_gen[p] = self._shard_gen.get(p, 0) + 1
        for hook in list(self._invalidation_hooks):
            hook(p)

    def file_size(self, name: str) -> int:
        return os.path.getsize(self._path(name))

    # ------------------------------------------------------------- metadata
    def write_meta(
        self, meta: GraphMeta, *, ell_params: Optional[Dict[str, int]] = None
    ) -> None:
        prop = {
            "num_vertices": meta.num_vertices,
            "num_edges": meta.num_edges,
            "num_shards": meta.num_shards,
            "intervals": meta.intervals.tolist(),
        }
        if ell_params is None:
            if self._ell_params is None and self.exists("property.json"):
                # a fresh process rewriting the metadata of an existing
                # store (e.g. a delta publish) carries the ELL block forward
                old = json.loads(self.read_bytes("property.json"))
                if "ell" in old:
                    self._ell_params = {k: int(v) for k, v in old["ell"].items()}
            ell_params = self._ell_params
        if ell_params is not None:
            # persisted so the delta overlay can rebuild the device (ELL)
            # format of a mutated shard without reading the base ELL file
            prop["ell"] = {k: int(ell_params[k]) for k in ("window", "k", "tr")}
            self._ell_params = prop["ell"]
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

    def ell_params(self) -> Dict[str, int]:
        """The (window, k, tr) every shard of this store was encoded with:
        the ``ell`` block of ``property.json``, else one read of shard 0's
        ELL container header."""
        if self._ell_params is None:
            if self.exists("property.json"):
                prop = json.loads(self.read_bytes("property.json"))
                if "ell" in prop:
                    self._ell_params = {k: int(v) for k, v in prop["ell"].items()}
            if self._ell_params is None:
                ell = self.decode_ell(0, self.shard_bytes(0, "ell"))
                self._ell_params = {"window": ell.window, "k": ell.k, "tr": ell.tr}
        return self._ell_params

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
        """Encode one shard's CSR + derived ELL container bytes without
        touching disk — shared by :meth:`write_shard` and recompaction's
        staged-rename swap (which writes to the staging dir itself)."""
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
        capture: Optional[Dict[Tuple[int, str], bytes]] = None,
    ) -> EllShard:
        """Persist CSR + derived device (ELL) format; returns the EllShard.

        Overwriting an existing shard id bumps the shard's generation and
        notifies every registered invalidation hook AFTER the new bytes
        land.  ``capture`` (ingest's cache warmup) receives the encoded
        container bytes, so a cache can be seeded without a read-back.
        """
        overwrite = self.exists(self.shard_name(shard.shard_id, "csr")) or self.exists(
            self.shard_name(shard.shard_id, "ell")
        )
        csr_raw, ell_raw, ell = self.encode_shard(
            shard, num_vertices=num_vertices, window=window, k=k, tr=tr
        )
        self.write_bytes(self.shard_name(shard.shard_id, "csr"), csr_raw)
        self.write_bytes(self.shard_name(shard.shard_id, "ell"), ell_raw)
        if capture is not None:
            capture[(shard.shard_id, "csr")] = csr_raw
            capture[(shard.shard_id, "ell")] = ell_raw
        if self._ell_params is None:
            self._ell_params = {"window": window, "k": k, "tr": tr}
        if overwrite:
            self.invalidate_shard(shard.shard_id)
        return ell

    def shard_bytes(self, p: int, fmt: str = "csr") -> memoryview:
        """Read the raw (uncompressed) shard container from disk, into a
        writable buffer that the read fills (no copy after it) and the
        decoders read in place (:func:`_load_npz_bytes`)."""
        name = self.shard_name(p, fmt)

        def fill(f):
            buf = np.empty(os.fstat(f.fileno()).st_size, dtype=np.uint8)
            n = f.readinto(memoryview(buf))
            if n != buf.size:
                raise IOError(f"{name}: read {n} of {buf.size} bytes")
            return memoryview(buf)

        return self._read(name, fill)

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
        # unpackbits writes only 0 and 1, so its bytes are bools as they are
        mask = np.unpackbits(z["mask_bits"], count=n_ell * k).view(bool)
        return EllShard(
            shard_id=p, v0=v0, v1=v1, num_vertices=nv, window=window, k=k, tr=tr,
            ell_idx=z["ell_idx"], ell_mask=mask.reshape(n_ell, k), seg=z["seg"],
            tile_window=z["tile_window"], nnz=nnz,
        )

    def load_shard(self, p: int, fmt: str = "csr", *, pin: Optional[int] = None):
        """Load ONE LOGICAL shard: base container plus any pending delta
        runs merged in (repro_torch.delta).  ``pin`` selects the delta
        snapshot (publish sequence) to decode at; ``None`` means the latest
        published state.  Without pending runs this is a plain base read +
        decode."""
        if self.delta is not None and self.delta.has_pending(p, pin):
            return self.delta.load_logical(p, fmt, pin=pin)[0]
        raw = self.shard_bytes(p, fmt)
        if fmt == "csr":
            return self.decode_csr(p, raw)
        return self.decode_ell(p, raw)

    def load_shards(self, ps: Sequence[int], fmt: str = "csr") -> Dict[int, object]:
        """Bulk read + decode of logical shards, all at one delta version
        (every raw resident at once — callers that need streaming chunk
        their own :meth:`shard_bytes_bulk` calls instead)."""
        pin = self.delta.version if self.delta is not None else None
        dirty = {p for p in ps
                 if self.delta is not None and self.delta.has_pending(p, pin)}
        out = {p: self.load_shard(p, fmt, pin=pin) for p in ps if p in dirty}
        raws = self.shard_bytes_bulk([p for p in ps if p not in dirty], fmt)
        decode = self.decode_csr if fmt == "csr" else self.decode_ell
        out.update({p: decode(p, raw) for p, raw in raws.items()})
        return out

    # ------------------------------------------------------------ ingestion
    def ingest(
        self,
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
    ):
        """Stream an on-disk edge file into this store — the out-of-core
        counterpart of ``preprocess`` + ``write_meta``/``write_shard``
        (two-pass external build, :mod:`repro_torch.core.ingest`).  Peak
        memory is O(chunk + one shard); the files are byte for byte those
        of the in-memory path.  Returns ``(GraphMeta, IngestStats)``."""
        from .ingest import ingest_edge_file  # local: avoids an import cycle

        return ingest_edge_file(
            self, path, edges_per_shard=edges_per_shard, num_shards=num_shards,
            num_vertices=num_vertices, chunk_edges=chunk_edges,
            mem_budget_bytes=mem_budget_bytes, window=window, k=k, tr=tr,
            fmt=fmt, finalize_workers=finalize_workers,
            warm_sources=warm_sources, warm_bytes=warm_bytes,
        )

    # ------------------------------------------------------ auxiliary blobs
    def write_aux(self, name: str, **arrays) -> None:
        self.write_bytes(f"aux_{name}.npz", _save_npz_bytes(**arrays))

    def read_aux(self, name: str) -> Dict[str, np.ndarray]:
        return _load_npz_bytes(self.read_bytes(f"aux_{name}.npz"))

    def aux_exists(self, name: str) -> bool:
        return self.exists(f"aux_{name}.npz")
