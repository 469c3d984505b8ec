"""Synthetic token data pipeline: sharded, deterministic, prefetched.

The port of ``repro/data/tokens.py``: pure numpy, so its batches are
bitwise the reference's.  Its loader raises a batch's error in the
consumer, where the reference's worker thread dies and leaves ``next``
waiting forever.

A production loader is storage-bound; this one is a drop-in stand-in with
the same contract: per-host deterministic sharding (host h sees disjoint
data), stateless resume from a step counter (fault tolerance: restart at
step k regenerates exactly the batches k, k+1, ... with no data loss or
duplication), and background prefetch of the next batch.

The token stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs so the LM loss actually decreases during the example runs
(pure-uniform tokens would pin loss at log V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    motif_prob: float = 0.5


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # independent stream per (seed, host, step) -> stateless resume
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.host_id, step])
    )


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for ``step`` (host-sharded slice of the global)."""
    rng = _batch_rng(cfg, step)
    per_host = cfg.global_batch // cfg.num_hosts
    S = cfg.seq_len
    # Zipf unigrams, clipped to vocab
    toks = rng.zipf(cfg.zipf_a, size=(per_host, S + 1)) % cfg.vocab_size
    # overlay repeated motifs (predictable structure)
    n_motifs = max(1, S // (4 * cfg.motif_len))
    for b in range(per_host):
        if rng.random() < cfg.motif_prob:
            motif = rng.integers(0, cfg.vocab_size, cfg.motif_len)
            for _ in range(n_motifs):
                at = rng.integers(0, S + 1 - cfg.motif_len)
                toks[b, at : at + cfg.motif_len] = motif
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def add_frontend_stub(batch: Dict, model_cfg: ModelConfig, step: int) -> Dict:
    """Attach precomputed frame/patch embeddings for [audio]/[vlm] archs."""
    rng = np.random.default_rng(step + 7)
    B = batch["tokens"].shape[0]
    if model_cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, model_cfg.prefix_len, model_cfg.d_model)
        ).astype(np.float32)
    elif model_cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal(
            (B, model_cfg.encoder_seq, model_cfg.d_model)
        ).astype(np.float32)
    return batch


class PrefetchingLoader:
    """Background-thread prefetch of the next ``depth`` batches."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None,
                 start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step, item = self._step, None
        while not self._stop.is_set():
            if item is None:
                try:
                    b = make_batch(self.cfg, step)
                    if self.model_cfg is not None and self.model_cfg.frontend != "none":
                        b = add_frontend_stub(b, self.model_cfg, step)
                    item = (step, b)
                except Exception as e:  # raised by __next__, not lost with the thread
                    item = e
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            if isinstance(item, Exception):
                return
            step, item = step + 1, None

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
