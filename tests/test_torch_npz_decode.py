"""The store's one-pass npz reader gives what ``np.load`` gives.

``repro_torch.core.storage._load_npz_bytes`` parses ``np.savez``
containers itself (CRC check and one copy a member) and leaves anything
else to ``np.load``; these tests hold it to ``np.load`` on the same bytes.
"""

import io
import zipfile

import numpy as np
import pytest

from repro_torch.core.csr import csr_to_ell
from repro_torch.core.sharding import ShardCSR
from repro_torch.core.storage import (ShardStore, _load_npz_bytes,
                                      _save_npz_bytes)

RNG = np.random.default_rng(7)
ARRAYS = {
    "int16": np.arange(-5, 11, dtype=np.int16),
    "empty_rows": np.zeros((0, 128), np.int32),
    "empty": np.array([], np.uint8),
    "scalar": np.array(5),
    "fortran": np.asfortranarray(RNG.random((3, 4))),
    "float32_3d": RNG.random((7, 3, 2)).astype(np.float32),
    "bool": np.array([True, False, True]),
    "unicode": np.array(["ab", "c"]),
    "big_endian": np.arange(6, dtype=">i4"),
    "record": np.array([(1, 2.0)], dtype=[("a", "<i4"), ("b", "<f8")]),
}


def _np_load(raw):
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_each_array_reads_as_np_load_reads_it(name):
    raw = _save_npz_bytes(**{name: ARRAYS[name]})
    got, want = _load_npz_bytes(raw)[name], _np_load(raw)[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.flags.writeable
    assert got.flags.c_contiguous == want.flags.c_contiguous
    assert got.flags.f_contiguous == want.flags.f_contiguous


def test_members_keep_their_order_and_own_their_memory():
    raw = _save_npz_bytes(**ARRAYS)
    got = _load_npz_bytes(raw)
    assert list(got) == list(_np_load(raw))
    got["int16"][0] = 99  # a copy: the container's bytes are not touched
    assert _load_npz_bytes(raw)["int16"][0] == -5


def test_a_corrupt_member_fails_its_crc_as_under_np_load():
    raw = bytearray(_save_npz_bytes(a=np.arange(8, dtype=np.int32)))
    raw[raw.find(np.arange(8, dtype=np.int32).tobytes()) + 4] ^= 1
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        _np_load(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        _load_npz_bytes(bytes(raw))


def test_a_compressed_container_falls_back_to_np_load():
    buf = io.BytesIO()
    np.savez_compressed(buf, x=np.arange(5), y=np.eye(2))
    got = _load_npz_bytes(buf.getvalue())
    assert list(got) == ["x", "y"]
    assert np.array_equal(got["x"], np.arange(5))
    assert np.array_equal(got["y"], np.eye(2))


def test_object_arrays_are_refused_as_under_np_load():
    raw = _save_npz_bytes(o=np.array([{"a": 1}], dtype=object))
    with pytest.raises(ValueError, match="allow_pickle"):
        _np_load(raw)
    with pytest.raises(ValueError, match="allow_pickle"):
        _load_npz_bytes(raw)


def test_an_ell_shard_decodes_to_the_planes_it_was_encoded_from(tmp_path):
    n, rows, edges = 600, 100, 900
    dst = np.sort(RNG.integers(0, rows, edges))
    src = RNG.integers(0, n, edges)
    row = np.searchsorted(dst, np.arange(rows + 1)).astype(np.int64)
    shard = ShardCSR(shard_id=3, v0=0, v1=rows, row=row,
                     col=src.astype(np.int32))
    _, ell_raw, ell = ShardStore(str(tmp_path)).encode_shard(
        shard, num_vertices=n, window=128, k=8, tr=4)
    got = ShardStore.decode_ell(3, ell_raw)
    want = csr_to_ell(shard, n, window=128, k=8, tr=4)
    for plane in ("ell_idx", "ell_mask", "seg", "tile_window"):
        a, b = getattr(got, plane), getattr(want, plane)
        assert a.dtype == b.dtype and np.array_equal(a, b), plane
        assert a.flags.writeable, plane
    assert got.ell_mask.dtype == np.bool_
    assert (got.nnz, got.v0, got.v1, got.k, got.tr) == (
        ell.nnz, ell.v0, ell.v1, ell.k, ell.tr)


@pytest.mark.parametrize("name", list(ARRAYS))
def test_a_writable_buffer_decodes_to_views_of_itself(name):
    raw = _save_npz_bytes(**{name: ARRAYS[name]})
    buf = np.frombuffer(raw, dtype=np.uint8).copy()
    got, want = _load_npz_bytes(buf)[name], _np_load(raw)[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.size == 0 or np.shares_memory(got, buf)
    assert not np.shares_memory(_load_npz_bytes(raw)[name], buf)


def test_the_store_reads_a_shard_into_a_writable_buffer(tmp_path):
    store = ShardStore(str(tmp_path))
    rows = 50
    row = np.linspace(0, 200, rows + 1).astype(np.int64)
    col = RNG.integers(0, 400, 200).astype(np.int32)
    store.write_shard(ShardCSR(shard_id=0, v0=0, v1=rows, row=row, col=col),
                      num_vertices=400, window=128, k=8, tr=4)
    for fmt in ("csr", "ell"):
        before = store.io.snapshot()
        buf = store.shard_bytes(0, fmt)
        read = store.io.snapshot() - before
        raw = store.read_bytes(store.shard_name(0, fmt))
        assert not buf.readonly and buf == raw
        assert (read.bytes_read, read.reads) == (len(raw), 1)
    a, b = ShardStore.decode_ell(0, buf), ShardStore.decode_ell(0, raw)
    for plane in ("ell_idx", "ell_mask", "seg", "tile_window"):
        assert np.array_equal(getattr(a, plane), getattr(b, plane)), plane
    assert np.shares_memory(a.ell_idx, buf)
