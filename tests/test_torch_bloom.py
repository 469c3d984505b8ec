"""Batched Bloom membership of the port against the reference's TPU kernel
(in interpret mode), its jnp oracle and the host ``BloomFilter32``, on the
same numpy inputs, over the shapes of the reference's own kernel tests.

Everything here is bit-exact: membership is integer arithmetic.  On the
CPU the wrapper runs the kernel's plain version; the CUDA kernel itself is
held against that on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.bloom import BloomFilter32 as RefBloomFilter32
from repro.kernels.bloom import ops as ref_ops
from repro.kernels.bloom import ref as ref_ref
from repro_torch.core.bloom import BloomFilter32
from repro_torch.kernels.bloom import kernel as K
from repro_torch.kernels.bloom import ops, ref

#: ids at the edges of int32, read as uint32 bit patterns by both hashes
EDGE_IDS = np.array([0, 1, -1, -2, 2**31 - 1, 2**31 - 2, -2**31, -2**31 + 1,
                     2**30, 123456789], dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(items, **kw):
    """The port's and the reference's filter over the same items."""
    f = BloomFilter32.build(items, **kw)
    g = RefBloomFilter32.build(items, **kw)
    assert np.array_equal(f.words, g.words) and f.num_bits == g.num_bits
    return f, g


def test_hash_matches_reference_at_int32_edges():
    rng = np.random.default_rng(0)
    ids = np.concatenate([EDGE_IDS, rng.integers(-2**31, 2**31, 4096,
                                                 dtype=np.int64).astype(np.int32)])
    h1, h2 = ref.hash2_u32(torch.from_numpy(ids))
    r1, r2 = ref_ref.hash2_u32(jnp.asarray(ids))
    assert np.array_equal(h1.numpy(), np.asarray(r1).astype(np.int64))
    assert np.array_equal(h2.numpy(), np.asarray(r2).astype(np.int64))


@pytest.mark.parametrize("n_items,num_hashes", [(100, 2), (5000, 4), (200, 8)])
def test_contains_bitexact_vs_reference_and_host(n_items, num_hashes):
    rng = np.random.default_rng(3)
    items = rng.choice(1 << 22, size=n_items, replace=False).astype(np.int32)
    f, g = _both(items, num_hashes=num_hashes)
    queries = rng.integers(0, 1 << 22, size=4096).astype(np.int32)
    host = f.contains(queries)
    got = ops.contains(f, queries, device="cpu")
    assert got.dtype == bool and np.array_equal(got, host)
    assert np.array_equal(got, ref_ops.contains(g, queries))
    refv = ref_ref.bloom_contains_ref(jnp.asarray(g.words), jnp.asarray(queries),
                                      num_bits=g.num_bits,
                                      num_hashes=g.num_hashes)
    assert np.array_equal(got, np.asarray(refv))
    assert ops.contains(f, items, device="cpu").all()  # no false negatives


def test_contains_at_int32_edges_and_odd_lengths():
    rng = np.random.default_rng(4)
    members = np.concatenate([EDGE_IDS[::2], rng.integers(0, 1 << 30, 500)
                              ]).astype(np.int32)
    f, g = _both(members, num_hashes=4)
    for n in (1, 7, 1023, 1025):
        q = np.concatenate([EDGE_IDS, rng.integers(-2**31, 2**31, n,
                                                   dtype=np.int64)]).astype(np.int32)
        got = ops.contains(f, q, device="cpu")
        assert np.array_equal(got, f.contains(q))
        assert np.array_equal(got, ref_ops.contains(g, q))
    assert ops.contains(f, EDGE_IDS[::2], device="cpu").all()
    assert ops.contains(f, np.array([], np.int32), device="cpu").shape == (0,)


def test_any_active_shards_matches_reference_and_host():
    rng = np.random.default_rng(4)
    sets = [rng.choice(10**6, 300, replace=False) for _ in range(5)]
    pairs = [_both(s) for s in sets]
    filters = [p[0] for p in pairs]
    ref_filters = [p[1] for p in pairs]
    active = sets[2][:3].astype(np.int32)  # only shard 2 truly active
    out = ops.any_active_shards(filters, active, device="cpu")
    assert out.dtype == bool and out.shape == (5,) and out[2]
    assert np.array_equal(out, ref_ops.any_active_shards(ref_filters, active))
    assert np.array_equal(out, [f.any_member(active) for f in filters])
    for ids in (np.array([], np.int32), np.array([-1] * 5, np.int32),
                rng.integers(0, 10**6, 3000).astype(np.int32)):
        out = ops.any_active_shards(filters, ids, device="cpu")
        assert np.array_equal(out, ref_ops.any_active_shards(ref_filters, ids))
        assert np.array_equal(out, [f.any_member(ids) for f in filters])
    assert not ops.any_active_shards(filters, np.array([], np.int32),
                                     device="cpu").any()


def test_padding_ids_never_activate_a_shard():
    """A filter holding -1: the reference's padding id would hit it, yet
    no padding is passed, so only the real ids decide."""
    f, g = _both(np.array([-1, 5, 9], np.int32))
    active = np.array([1000, 2000], np.int32)
    assert not f.contains(active).any()
    assert not ops.any_active_shards([f], active, device="cpu")[0]
    assert not ref_ops.any_active_shards([g], active)[0]
    assert ops.any_active_shards([f, f], np.array([9], np.int32),
                                 device="cpu").tolist() == [True, True]


def test_kernel_wrapper_many_filters_and_reduce():
    rng = np.random.default_rng(6)
    filters = [BloomFilter32.build(rng.choice(1 << 20, n, replace=False),
                                   num_hashes=h)
               for n, h in ((50, 2), (700, 4), (3000, 7))]
    staged = ops.stage_filters(filters, "cpu")
    items = torch.from_numpy(rng.integers(0, 1 << 20, 2000).astype(np.int32))
    kw = dict(num_bits=staged.num_bits, num_hashes=staged.num_hashes)
    bits = K.bloom_contains(staged.words, items, **kw)
    assert bits.shape == (3, 2000) and bits.dtype == torch.bool
    for p, f in enumerate(filters):
        assert np.array_equal(bits[p].numpy(), f.contains(items.numpy()))
        one = K.bloom_contains(staged.words[p], items, num_bits=f.num_bits,
                               num_hashes=f.num_hashes)
        assert one.shape == (2000,) and torch.equal(one, bits[p])
    anyv = K.bloom_contains(staged.words, items, reduce_any=True, **kw)
    assert torch.equal(anyv, bits.any(dim=1))
    assert torch.equal(anyv, K.bloom_contains_plain(staged.words, items,
                                                    reduce_any=True, **kw))
    assert K.bloom_contains.launches == 0  # the CPU never launches


def test_pad_items_matches_reference():
    for n in (0, 1, 1024, 1500):
        x = np.arange(n, dtype=np.int32)
        assert np.array_equal(ops.pad_items(x), ref_ops.pad_items(x))


def test_wrapper_refuses_mixed_devices_and_bad_tables():
    f = BloomFilter32.build(np.arange(100))
    words = torch.from_numpy(f.words)
    with pytest.raises(ValueError, match="per filter"):
        K.bloom_contains([words, words], torch.zeros(3, dtype=torch.int32),
                         num_bits=[f.num_bits], num_hashes=4)
    with pytest.raises(TypeError):
        ref.words_as_int64(words.to(torch.int64))


# ------------------------------------------------ the "any" output's protocol
# csrc/bloom.cu's any-reduction: warps take the filters in a turn from their
# own index, skip a filter whose bit they know (from the block's word or the
# state's), set the block's and the state's bit at a hit, and leave once
# every bit is set; at the end each block counts itself in a per-stream
# state and the last one writes the flags and zeroes the state.  Numpy
# models of both, under random interleavings.


def _any_scan(hits, blocks_of, rng):
    """The warps' scan, one step of a random warp at a time: ``hits[w, p]``
    says some id of warp w's turn hits filter p.  A warp reads the state's
    word at the start of its turn and the block's before each filter, and
    leaves once every bit is set.  Returns the state's word and the
    probes made (warp, filter)."""
    n_warps, n_filters = hits.shape
    every = (1 << n_filters) - 1
    seen, block_seen = 0, {}
    pos = [0] * n_warps  # filters each warp has taken
    known = [None] * n_warps
    probes = []
    live = list(range(n_warps))
    while live:
        w = live[int(rng.integers(len(live)))]
        b = blocks_of[w]
        if known[w] is None:
            known[w] = seen
            block_seen[b] = block_seen.get(b, 0) | seen
        if known[w] == every or pos[w] == n_filters:
            live.remove(w)
            continue
        p = (w + pos[w]) % n_filters
        pos[w] += 1
        known[w] |= block_seen.get(b, 0)
        if (known[w] >> p) & 1:
            continue
        probes.append((w, p))
        if hits[w, p]:
            if not (block_seen.get(b, 0) >> p) & 1:
                block_seen[b] = block_seen.get(b, 0) | (1 << p)
                seen |= 1 << p
            known[w] |= 1 << p
    return seen, probes


def test_any_scan_sets_exactly_the_hit_filters():
    """Random hit patterns (none, rare, every warp) and interleavings: the
    state's word is the OR of the hits per filter, whatever the order; no
    filter is skipped before some warp set its bit; and where every warp
    hits every filter the scan stops after far fewer probes than a full
    pass."""
    rng = np.random.default_rng(7)
    for rep in range(60):
        n_warps, n_filters = int(rng.integers(1, 64)), int(rng.integers(1, 65))
        hits = rng.random((n_warps, n_filters)) < (0.0, 0.002, 0.05, 1.0)[rep % 4]
        blocks_of = [w // 8 for w in range(n_warps)]
        seen, probes = _any_scan(hits, blocks_of, rng)
        want = sum(1 << p for p in range(n_filters) if hits[:, p].any())
        assert seen == want, rep
        if rep % 4 == 3 and n_warps * n_filters > 64:
            assert len(probes) < n_warps * n_filters


def _any_finish(state, bits, order):
    """The end of one launch on a shared state (seen word, done count):
    block b ORs the filters its ids hit (bits[b]: a bool per filter), then
    counts itself; blocks finish in ``order``; the last writes the flags
    and zeroes the state."""
    flags = None
    for b in order:
        state["seen"] |= sum(1 << p for p, hit in enumerate(bits[b]) if hit)
        state["done"] += 1
        if state["done"] == len(order):  # the last block
            word, state["seen"], state["done"] = state["seen"], 0, 0
            flags = [bool((word >> p) & 1) for p in range(len(bits[b]))]
    return flags


def test_any_completion_protocol_is_any_of_the_bits():
    """Random block orders and repeated calls on one state: every call's
    flags are any() of its blocks' bits per filter, and the state is zero
    after each call, so the next call needs no clearing."""
    rng = np.random.default_rng(3)
    state = {"seen": 0, "done": 0}
    for call in range(100):
        n_blocks, n_filters = int(rng.integers(1, 300)), int(rng.integers(1, 65))
        p_hit = (0.0, 0.001, 0.05)[call % 3]
        bits = rng.random((n_blocks, n_filters)) < p_hit
        flags = _any_finish(state, bits, rng.permutation(n_blocks))
        assert flags == bits.any(axis=0).tolist()
        assert state == {"seen": 0, "done": 0}
