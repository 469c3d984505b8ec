"""Plain PyTorch oracle for batched Bloom membership (32-bit device variant).

Bit-exact with :class:`repro_torch.core.bloom.BloomFilter32`: the same hash
constants, the same probe schedule (Kirsch-Mitzenmacher double hashing) and
the same power-of-two modulo mask.  torch on the CPU has no ``>>`` for
uint32, so the hashes are computed in int64 holding values below 2^32,
with every product formed from 16-bit halves so nothing passes 2^63.
"""

from __future__ import annotations

import torch

__all__ = ["ADD", "MUL1", "MUL2", "bloom_contains_ref", "hash2_u32",
           "words_as_int64"]

MUL1 = 0x9E3779B1
MUL2 = 0x85EBCA77
ADD = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c`` below 2^32: ``x_lo * c`` < 2^48 and ``x_hi * c_lo`` < 2^32."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def hash2_u32(items: torch.Tensor) -> tuple:
    """``(h1, h2)``: the two uint32 hashes of int32 ids, as int64 tensors
    holding the uint32 values (an id is read as its uint32 bit pattern)."""
    x = items.to(torch.int64) & _M32
    h1 = _mul32(x, MUL1)
    h1 = h1 ^ (h1 >> 15)
    h2 = _mul32((x + ADD) & _M32, MUL2)
    h2 = h2 ^ (h2 >> 13)
    return h1, h2 | 1


def words_as_int64(words: torch.Tensor) -> torch.Tensor:
    """A uint32 (or int32 bit-pattern) word table as int64 in [0, 2^32)."""
    if words.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"words: dtype {words.dtype} is not uint32 or int32")
    return words.view(torch.int32).to(torch.int64) & _M32


def bloom_contains_ref(words: torch.Tensor, items: torch.Tensor, *,
                       num_bits: int, num_hashes: int) -> torch.Tensor:
    """bool ``[n]``: item (possibly) present?"""
    h1, h2 = hash2_u32(items)
    table = words_as_int64(words)
    hit = torch.ones(items.shape, dtype=torch.bool, device=items.device)
    for i in range(num_hashes):
        pos = (h1 + i * h2) & (num_bits - 1)
        w = table[pos >> 5]
        hit &= ((w >> (pos & 31)) & 1) != 0
    return hit
