"""Bloom filters for selective scheduling (paper §II-D-1).

Each shard owns a Bloom filter over the *source* vertices of its edges.  At
the start of an iteration, if the active-vertex ratio is below the paper's
threshold (0.001), the engine tests every shard's filter against the active
set: a shard whose filter matches no active vertex is *inactive* — loading
and processing it cannot produce updates, so it is skipped (no disk read,
no compute).  False positives only cost a wasted load, never correctness.

The filter is a bit-packed ``uint64`` array with ``k`` double-hashed probes
(h1 + i*h2, the standard Kirsch-Mitzenmacher construction) using two
Fibonacci/multiplicative hashes — branch-free and fully vectorised with
numpy so membership of a whole active-vertex array is one batched call.
``BloomFilter32`` is the 32-bit variant a device membership kernel mirrors
bit for bit; the port's scheduler uses the host filters.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["BloomFilter", "build_shard_filters", "optimal_num_bits"]

_MUL1 = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / golden ratio
_MUL2 = np.uint64(0xC2B2AE3D27D4EB4F)  # xxhash64 prime 2


def _hash2(x: np.ndarray) -> tuple:
    """Two independent 64-bit multiplicative hashes of int vertex ids."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        h1 = x * _MUL1
        h1 ^= h1 >> np.uint64(29)
        h2 = (x + np.uint64(0x165667B19E3779F9)) * _MUL2
        h2 ^= h2 >> np.uint64(31)
        h2 |= np.uint64(1)  # odd stride so probes cover the table
    return h1, h2


def optimal_num_bits(n_items: int, fp_rate: float = 0.01) -> int:
    """Textbook m = -n ln(p) / (ln 2)^2, rounded up to a multiple of 64."""
    n_items = max(n_items, 1)
    m = int(np.ceil(-n_items * np.log(fp_rate) / (np.log(2.0) ** 2)))
    return max(64, ((m + 63) // 64) * 64)


@dataclasses.dataclass
class BloomFilter:
    bits: np.ndarray  # uint64 [num_bits // 64]
    num_bits: int
    num_hashes: int
    n_items: int = 0

    @classmethod
    def build(
        cls, items: np.ndarray, *, fp_rate: float = 0.01, num_hashes: int = 4
    ) -> "BloomFilter":
        items = np.asarray(items)
        num_bits = optimal_num_bits(len(items), fp_rate)
        f = cls(
            bits=np.zeros(num_bits // 64, dtype=np.uint64),
            num_bits=num_bits,
            num_hashes=num_hashes,
            n_items=len(items),
        )
        f.add(items)
        return f

    def _positions(self, items: np.ndarray) -> np.ndarray:
        """Bit positions, shape [len(items), num_hashes]."""
        h1, h2 = _hash2(np.asarray(items))
        i = np.arange(self.num_hashes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            pos = h1[:, None] + i[None, :] * h2[:, None]
        return (pos % np.uint64(self.num_bits)).astype(np.int64)

    def add(self, items: np.ndarray) -> None:
        if len(items) == 0:
            return
        pos = self._positions(items).ravel()
        word, bit = pos >> 6, pos & 63
        np.bitwise_or.at(self.bits, word, np.uint64(1) << bit.astype(np.uint64))

    def contains(self, items: np.ndarray) -> np.ndarray:
        """Vectorised membership test -> bool [len(items)]."""
        items = np.asarray(items)
        if len(items) == 0:
            return np.zeros(0, dtype=bool)
        pos = self._positions(items)
        word, bit = pos >> 6, pos & 63
        hits = (self.bits[word] >> bit.astype(np.uint64)) & np.uint64(1)
        return hits.astype(bool).all(axis=1)

    def any_member(self, items: np.ndarray) -> bool:
        """Does the filter (possibly) contain ANY of ``items``?

        This is the paper's ``Bloom_filter[shard.id].has(active_vertices)``
        check — the shard-skip decision.
        """
        if len(items) == 0:
            return False
        # Chunked so huge active sets don't materialise a big position matrix.
        items = np.asarray(items)
        for lo in range(0, len(items), 65536):
            if self.contains(items[lo : lo + 65536]).any():
                return True
        return False

    def fp_rate_estimate(self) -> float:
        """(1 - e^{-kn/m})^k using the actual bit occupancy."""
        load = np.unpackbits(self.bits.view(np.uint8)).mean()
        return float(load**self.num_hashes)

    # ------------------------------------------------------- device mirror
    def device_words(self) -> np.ndarray:
        """uint32 view of the filter bits, for a 32-bit device kernel."""
        return self.bits.view(np.uint32).copy()


def build_shard_filters(
    shards: Sequence, *, fp_rate: float = 0.01, num_hashes: int = 4
) -> list:
    """One filter per shard over the shard's unique source vertices."""
    return [
        BloomFilter.build(s.unique_sources(), fp_rate=fp_rate, num_hashes=num_hashes)
        for s in shards
    ]


# ---------------------------------------------------------------------------
# 32-bit variant: the device filter.  A membership kernel uses uint32
# arithmetic with a power-of-two bit count (modulo becomes a mask); this
# host class is the bit-exact mirror such a kernel is tested against.
# ---------------------------------------------------------------------------

_MUL1_32 = np.uint32(0x9E3779B1)  # 2^32 / golden ratio
_MUL2_32 = np.uint32(0x85EBCA77)  # murmur3 c1-ish
_ADD_32 = np.uint32(0x27D4EB2F)


def _hash2_u32(x: np.ndarray) -> tuple:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        h1 = x * _MUL1_32
        h1 ^= h1 >> np.uint32(15)
        h2 = (x + _ADD_32) * _MUL2_32
        h2 ^= h2 >> np.uint32(13)
        h2 |= np.uint32(1)
    return h1, h2


@dataclasses.dataclass
class BloomFilter32:
    words: np.ndarray  # uint32 [num_bits // 32]
    num_bits: int  # power of two
    num_hashes: int
    n_items: int = 0

    @classmethod
    def build(
        cls, items: np.ndarray, *, fp_rate: float = 0.01, num_hashes: int = 4
    ) -> "BloomFilter32":
        items = np.asarray(items)
        m = optimal_num_bits(len(items), fp_rate)
        num_bits = 1 << int(np.ceil(np.log2(max(m, 32))))
        f = cls(
            words=np.zeros(num_bits // 32, dtype=np.uint32),
            num_bits=num_bits,
            num_hashes=num_hashes,
            n_items=len(items),
        )
        f.add(items)
        return f

    def _positions(self, items: np.ndarray) -> np.ndarray:
        h1, h2 = _hash2_u32(np.asarray(items))
        i = np.arange(self.num_hashes, dtype=np.uint32)
        with np.errstate(over="ignore"):
            pos = h1[:, None] + i[None, :] * h2[:, None]
        return (pos & np.uint32(self.num_bits - 1)).astype(np.int64)

    def add(self, items: np.ndarray) -> None:
        if len(items) == 0:
            return
        pos = self._positions(items).ravel()
        word, bit = pos >> 5, pos & 31
        np.bitwise_or.at(self.words, word, np.uint32(1) << bit.astype(np.uint32))

    def contains(self, items: np.ndarray) -> np.ndarray:
        items = np.asarray(items)
        if len(items) == 0:
            return np.zeros(0, dtype=bool)
        pos = self._positions(items)
        word, bit = pos >> 5, pos & 31
        hits = (self.words[word] >> bit.astype(np.uint32)) & np.uint32(1)
        return hits.astype(bool).all(axis=1)

    def any_member(self, items: np.ndarray) -> bool:
        if len(items) == 0:
            return False
        items = np.asarray(items)
        for lo in range(0, len(items), 65536):
            if self.contains(items[lo : lo + 65536]).any():
                return True
        return False
