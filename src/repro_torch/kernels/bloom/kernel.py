"""The Hopper Bloom-membership kernel, with its plain version.

:func:`bloom_contains` launches the kernel written in CUDA C++ in
``repro_torch/csrc/bloom.cu`` (the source note there gives its bound and
design).  It replaces the TPU kernel
``repro/kernels/bloom/kernel.py::bloom_contains``: batched membership of
int32 ids in a Bloom filter's uint32 word table, bit-exact with the host
``BloomFilter32``.  Unlike the TPU kernel it takes any number of ids (no
padding to 1024) and several filters in one launch, each with its own
size, and can reduce each filter's bits to one "any id hits" flag on the
card (the shard-activity test).

The wrapper takes its plain PyTorch version for CPU tensors only.  For
CUDA tensors it launches the kernel or raises; it never falls back.  It
counts its launches in ``bloom_contains.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import torch

from ..build import library
from .ref import bloom_contains_ref

__all__ = ["MAX_FILTERS", "MAX_HASHES", "bloom_contains",
           "bloom_contains_plain"]

#: most filters one launch takes (``kMaxFilters`` in ``bloom.cu``)
MAX_FILTERS = 64
#: most probes an id (``kMaxHashes``)
MAX_HASHES = 16

Ints = Union[int, Sequence[int]]


def _filters(words, num_bits: Ints, num_hashes: Ints):
    """``(words, num_bits, num_hashes)`` as lists, one entry a filter, and
    whether a single filter (a bare tensor) was given."""
    single = isinstance(words, torch.Tensor)
    words = [words] if single else list(words)
    nb = [num_bits] * len(words) if isinstance(num_bits, int) else list(num_bits)
    nh = ([num_hashes] * len(words) if isinstance(num_hashes, int)
          else list(num_hashes))
    if not words or not len(words) == len(nb) == len(nh):
        raise ValueError("need one num_bits and num_hashes per filter")
    return words, [int(b) for b in nb], [int(h) for h in nh], single


def _shape(out: torch.Tensor, single: bool) -> torch.Tensor:
    return out[0] if single else out


def bloom_contains_plain(words, items: torch.Tensor, *, num_bits: Ints,
                         num_hashes: Ints, reduce_any: bool = False
                         ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: :func:`ref.
    bloom_contains_ref` per filter, and ``any`` over the ids per filter
    when ``reduce_any``."""
    words, nb, nh, single = _filters(words, num_bits, num_hashes)
    hits = torch.stack([bloom_contains_ref(w, items, num_bits=b, num_hashes=h)
                        for w, b, h in zip(words, nb, nh)])
    return _shape(hits.any(dim=1) if reduce_any else hits, single)


def _check(words: List[torch.Tensor], items: torch.Tensor, nb: List[int],
           nh: List[int]) -> None:
    if items.dtype != torch.int32 or items.dim() != 1 or not items.is_contiguous():
        raise TypeError(f"items: need a contiguous 1-D int32 tensor, got "
                        f"{items.dtype} {tuple(items.shape)}")
    for w, b, h in zip(words, nb, nh):
        if w.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"words: dtype {w.dtype} is not uint32 or int32")
        if b < 32 or b > 1 << 32 or b & (b - 1):
            raise ValueError(f"num_bits {b} is not a power of two in [32, 2^32]")
        if w.dim() != 1 or not w.is_contiguous() or w.numel() != b // 32:
            raise ValueError(f"words: need a contiguous [{b // 32}] table, got "
                             f"{tuple(w.shape)}")
        if not 1 <= h <= MAX_HASHES:
            raise ValueError(f"num_hashes {h} not in [1, {MAX_HASHES}]")


#: (device, stream) -> the any-reduction's state on that stream
_STATES: Dict[Tuple[int, int], torch.Tensor] = {}


def _any_state(stream: torch.cuda.Stream) -> torch.Tensor:
    """The any-reduction's 16-byte state for launches on ``stream``: its
    word of hit bits and its count of finished blocks.  Made zero once;
    each launch leaves it zero again, so a call needs no clearing launch.
    One per stream, so launches on two streams never share one."""
    key = (stream.device.index, stream.cuda_stream)
    state = _STATES.get(key)
    if state is None:
        state = _STATES[key] = torch.zeros(2, dtype=torch.int64, device=stream.device)
    return state


def bloom_contains(words, items: torch.Tensor, *, num_bits: Ints,
                   num_hashes: Ints, reduce_any: bool = False) -> torch.Tensor:
    """Membership bits of int32 ``items [n]`` (CUDA kernel on the card).

    ``words`` is one filter's uint32 (or int32 bit-pattern) table of
    ``num_bits // 32`` words, or a sequence of such tables with a
    ``num_bits``/``num_hashes`` each (or one for all).  Returns bool ``[n]``
    for one table and ``[F, n]`` for F; with ``reduce_any``, whether any
    id hits: a 0-d bool for one table, ``[F]`` for F.
    """
    words, nb, nh, single = _filters(words, num_bits, num_hashes)
    devs = {t.device for t in (*words, items)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return bloom_contains_plain(words[0] if single else words, items,
                                    num_bits=nb, num_hashes=nh,
                                    reduce_any=reduce_any)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(words, items, nb, nh)
    n, F = items.numel(), len(words)
    shape = (F,) if reduce_any else (F, n)
    if n == 0:
        return _shape(torch.zeros(shape, dtype=torch.bool, device=dev), single)
    out = torch.empty(shape, dtype=torch.bool, device=dev)  # every flag written
    stream = torch.cuda.current_stream(dev)
    state = _any_state(stream) if reduce_any else None
    fn = library("bloom").bloom_contains
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    handle = ctypes.c_void_p(stream.cuda_stream)
    for lo in range(0, F, MAX_FILTERS):
        hi = min(F, lo + MAX_FILTERS)
        part = out[lo:hi]
        with torch.cuda.device(dev):
            rc = fn((ctypes.c_void_p * (hi - lo))(*[w.data_ptr() for w in words[lo:hi]]),
                    (ctypes.c_ulonglong * (hi - lo))(*nb[lo:hi]),
                    (ctypes.c_int * (hi - lo))(*nh[lo:hi]), hi - lo,
                    items.data_ptr(), n, int(reduce_any), part.data_ptr(),
                    None if state is None else state.data_ptr(), handle)
        if rc != 0:
            raise RuntimeError(f"bloom_contains launch failed: CUDA error {rc}")
        bloom_contains.launches += 1
    return _shape(out, single)


bloom_contains.launches = 0
