"""Prefetching shard loader: *how shards get loaded* (DESIGN.md §3).

Second layer of the engine stack.  Given an ordered plan, the pipeline
yields decoded shards in plan order while a small thread pool runs
``depth`` loads ahead — disk read (or cache hit) + decompress + numpy
decode all happen off the critical path, so the consumer working on shard
``i`` overlaps the I/O of shards ``i+1 .. i+depth`` (paper §II-C, Fig. 3).
``depth == 0`` degrades to a plain synchronous loop; results are bitwise
the same either way, since consumption order is always plan order.

With a ``device``, ELL shards are moved there on the CONSUMER thread
(:func:`~repro_torch.core.csr.ell_to_device`: the host->device copy plus
the combine order), so prefetch threads never touch the device.  With a
``resident`` dict the device copies are kept and reused on later
iterations without touching cache, disk, decode or the copy again.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Union

from ..obs import trace
from .cache import ShardCache
from .csr import DeviceEll, EllShard, ell_to_device
from .sharding import ShardCSR
from .storage import ShardStore

__all__ = ["LoadedShard", "PipelineStats", "ShardLoadError", "ShardPipeline"]


class ShardLoadError(RuntimeError):
    """A prefetch-thread (or inline) shard load failed.  Raised at the
    consuming iterator with the failing shard id attached (``exc.shard_id``)
    and the loader's exception chained as ``__cause__``."""

    def __init__(self, shard_id: int, cause: BaseException):
        super().__init__(f"shard {shard_id} failed to load: {cause!r}")
        self.shard_id = shard_id


@dataclasses.dataclass
class LoadedShard:
    """One decoded shard plus where it came from and what it cost."""

    shard_id: int
    csr: Optional[ShardCSR]
    ell: Union[EllShard, DeviceEll, None]
    load_s: float = 0.0  # in-thread (or inline) load+decode duration
    wait_s: float = 0.0  # critical-path stall until this shard was ready
    to_device_s: float = 0.0  # consumer-side host->device copy + order
    from_cache: bool = False
    from_resident: bool = False
    generation: int = 0  # store generation snapshot taken before the read

    @property
    def ref(self):
        """The backend-facing shard object (csr for numpy, ell otherwise)."""
        return self.csr if self.csr is not None else self.ell


@dataclasses.dataclass
class PipelineStats:
    """Per-iteration load/overlap accounting (reset each iteration)."""

    shards_loaded: int = 0
    load_total_s: float = 0.0  # sum of load durations (hidden + exposed)
    wait_s: float = 0.0  # exposed: consumer stalled on a future
    to_device_s: float = 0.0  # exposed: consumer-side device copies

    @property
    def overlap_s(self) -> float:
        """Load work hidden behind compute — the paper's Fig. 3 win."""
        return max(0.0, self.load_total_s - self.wait_s)

    def reset(self) -> None:
        self.shards_loaded = 0
        self.load_total_s = self.wait_s = self.to_device_s = 0.0


class ShardPipeline:
    """Walks a shard plan with depth-configurable background prefetch."""

    def __init__(
        self,
        store: ShardStore,
        fmt: str,
        *,
        cache: Optional[ShardCache] = None,
        depth: int = 2,
        device=None,
        resident: Optional[Dict[int, DeviceEll]] = None,
    ):
        if depth < 0:
            raise ValueError("prefetch depth must be >= 0")
        if resident is not None and (device is None or fmt != "ell"):
            raise ValueError("resident shards need an ELL pipeline with a device")
        self.store = store
        self.fmt = fmt
        self.cache = cache
        self.depth = depth
        self.device = device
        self.resident = resident  # shard_id -> DeviceEll, engine-owned
        self._resident_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._finalizer = None

    # ----------------------------------------------------------- lifecycle
    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.depth, thread_name_prefix="shard-prefetch"
            )
            self._finalizer = weakref.finalize(
                self, ThreadPoolExecutor.shutdown, self._pool, wait=False
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None

    def drop_resident(self, p: int) -> None:
        if self.resident is not None:
            with self._resident_lock:
                self.resident.pop(p, None)

    # ---------------------------------------------------------------- load
    def _load(self, p: int) -> LoadedShard:
        """Cache lookup -> disk read -> decode, off the critical path when
        called from a prefetch thread.  Failures are wrapped in
        :class:`ShardLoadError` carrying the shard id."""
        with trace.span("shard.load", shard=p) as sp:
            try:
                ls = self._load_impl(p)
            except ShardLoadError:
                raise
            except Exception as exc:
                raise ShardLoadError(p, exc) from exc
            sp.set(
                from_cache=ls.from_cache,
                from_resident=ls.from_resident,
                load_ms=ls.load_s * 1e3,
            )
            return ls

    def _load_impl(self, p: int) -> LoadedShard:
        t0 = time.perf_counter()
        if self.resident is not None:
            with self._resident_lock:
                dev = self.resident.get(p)
            if dev is not None:
                return LoadedShard(p, None, dev, load_s=time.perf_counter() - t0,
                                   from_resident=True)
        # Snapshot the generation BEFORE the read: an overwrite landing
        # between our read and our cache insert moves it, and we discard.
        gen0 = self.store.shard_generation(p)
        from_cache = False
        raw = self.cache.get(p) if self.cache is not None else None
        if raw is not None:
            from_cache = True
        else:
            raw = self.store.shard_bytes(p, self.fmt)
            if self.cache is not None:
                self.cache.put(p, raw)
                if self.store.shard_generation(p) != gen0:
                    self.cache.invalidate(p)  # raced with an overwrite
        with trace.span("shard.decode", shard=p, fmt=self.fmt):
            if self.fmt == "csr":
                csr, ell = self.store.decode_csr(p, raw), None
            else:
                csr, ell = None, self.store.decode_ell(p, raw)
        return LoadedShard(p, csr, ell, load_s=time.perf_counter() - t0,
                           from_cache=from_cache, generation=gen0)

    def _to_device(self, ls: LoadedShard) -> LoadedShard:
        """Consumer-thread step: move a host ELL shard to the device and,
        in resident mode, keep the device copy."""
        if self.device is None or not isinstance(ls.ell, EllShard):
            return ls
        t0 = time.perf_counter()
        with trace.span("shard.to_device", shard=ls.shard_id):
            ls.ell = ell_to_device(ls.ell, self.device)
        if self.resident is not None:
            with self._resident_lock:
                self.resident[ls.shard_id] = ls.ell
            if self.store.shard_generation(ls.shard_id) != ls.generation:
                self.drop_resident(ls.shard_id)  # same race, device form
        ls.to_device_s = time.perf_counter() - t0
        return ls

    def load(self, p: int) -> LoadedShard:
        """Synchronous single-shard load (the depth=0 path, also public)."""
        ls = self._load(p)
        ls.wait_s = ls.load_s  # nothing hidden: full latency is exposed
        return self._to_device(ls)

    # ---------------------------------------------------------------- walk
    def iter_shards(
        self,
        shard_ids: Sequence[int],
        stats: Optional[PipelineStats] = None,
    ) -> Iterator[LoadedShard]:
        """Yield loaded shards in plan order, prefetching ``depth`` ahead."""
        if self.depth == 0:
            for p in shard_ids:
                ls = self.load(p)
                self._account(ls, stats)
                yield ls
            return

        pool = self._ensure_pool()
        shard_ids = list(shard_ids)
        pending: Dict[int, Future] = {}
        next_submit = 0

        def top_up():
            nonlocal next_submit
            while next_submit < len(shard_ids) and len(pending) < self.depth:
                pending[next_submit] = pool.submit(self._load,
                                                   shard_ids[next_submit])
                next_submit += 1

        try:
            top_up()
            for i in range(len(shard_ids)):
                fut = pending.pop(i)
                t0 = time.perf_counter()
                with trace.span("shard.wait", shard=shard_ids[i]):
                    ls = fut.result()  # re-raises ShardLoadError
                ls.wait_s = time.perf_counter() - t0
                top_up()  # keep the window full while we still hold the shard
                ls = self._to_device(ls)
                self._account(ls, stats)
                yield ls
        finally:
            # Abnormal exit: drain the prefetch window, so the next sweep
            # starts with idle prefetch threads and no stale loads.
            for fut in pending.values():
                fut.cancel()
            for fut in pending.values():
                if not fut.cancelled():
                    try:
                        fut.result()
                    except Exception:
                        pass  # the primary failure already surfaced
            pending.clear()

    @staticmethod
    def _account(ls: LoadedShard, stats: Optional[PipelineStats]) -> None:
        if stats is None:
            return
        stats.shards_loaded += 1
        stats.load_total_s += ls.load_s
        stats.wait_s += ls.wait_s
        stats.to_device_s += ls.to_device_s
