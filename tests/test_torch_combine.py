"""The lane combine's fold order (``csrc/spmv_ell.cu``,
``segment_combine_lanes_kernel``), modelled in numpy in float32 with the
card's fold arithmetic: its 32 accumulators in registers, then the tree as
seen from thread 0, must give the bits of the single-lane combine
(``segment_combine_kernel``): 32 threads, each folding every 32nd entry in
ascending order, then an xor-shuffle tree.  So lane l of the lane combine is
bitwise ``segment_combine`` on lane l, for every combine and any number of
entries a destination row.
"""

import re
from pathlib import Path

import numpy as np
import pytest

COMBINES = ["sum", "min", "max"]
_FOLD = {"sum": lambda a, b: np.float32(a + b), "min": np.fmin, "max": np.fmax}
_IDENTITY = {"sum": np.float32(0.0), "min": np.float32(np.inf),
             "max": np.float32(-np.inf)}
#: destination rows of 0, 1, 31, 32, 33 and 1,000 entries: no batch, a
#: partial one, a full one, one past it, and many
ENTRIES = [0, 1, 31, 32, 33, 1000]


def _shuffle_combine(vals, combine):
    """segment_combine: thread t folds entries t, t + 32, ... in order from
    the identity; then each thread t folds its partner t ^ off, for off =
    16 ... 1, and thread 0 holds the result."""
    fold = _FOLD[combine]
    acc = [_IDENTITY[combine]] * 32
    for t in range(32):
        for v in vals[t::32]:
            acc[t] = fold(acc[t], v)
    off = 16
    while off:
        acc = [fold(acc[t], acc[t ^ off]) for t in range(32)]
        off //= 2
    return acc[0]


def _register_combine(vals, combine):
    """The lane combine: batches of 32 entries, entry i of a batch folded
    into accumulator i; then acc[q] = fold(acc[q], acc[q + off]) for
    q < off, off = 16 ... 1, every fold kept."""
    fold = _FOLD[combine]
    acc = [_IDENTITY[combine]] * 32
    for j0 in range(0, len(vals), 32):
        batch = vals[j0:j0 + 32]
        for i in range(len(batch)):
            acc[i] = fold(acc[i], batch[i])
    off = 16
    while off:
        for q in range(off):
            acc[q] = fold(acc[q], acc[q + off])
        off //= 2
    return acc[0]


def _bits(x):
    return np.float32(x).view(np.uint32)


@pytest.mark.parametrize("n", ENTRIES)
@pytest.mark.parametrize("combine", COMBINES)
def test_lane_combine_register_tree_is_the_shuffle_order(n, combine):
    """Rows of mixed magnitudes, with -0.0, +-inf and NaN among some of
    them: the register tree's bits are the shuffle order's; over every row
    of 33 entries or more a plain ascending fold gives other bits for the
    sum at least once, so the check can fail."""
    rng = np.random.default_rng(n)
    special = np.float32([-0.0, 0.0, np.inf, -np.inf, np.nan])
    differs = 0
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf, NaN
        for r in range(40):
            vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
            pick = rng.random(n) < (0.0, 0.02, 0.2, 1.0)[r % 4]  # some rows all finite
            vals[pick] = rng.choice(special, int(pick.sum()))
            want = _shuffle_combine(vals, combine)
            assert _bits(_register_combine(vals, combine)) == _bits(want), (r, vals)
            flat = _IDENTITY[combine]
            for v in vals:
                flat = _FOLD[combine](flat, v)
            differs += bool(_bits(flat) != _bits(want))
    if combine == "sum" and n > 32:
        assert differs > 0
    if n == 0:  # an empty row: the identity
        assert _bits(_register_combine(vals, combine)) == _bits(_IDENTITY[combine])


def test_register_tree_keeps_a_negative_zero_row():
    """A row of -0.0 entries: both orders fold them into +0.0 accumulators
    (-0.0 + +0.0 is +0.0), so the sum is +0.0 either way; fmin keeps -0.0
    beside the +inf identity."""
    vals = np.float32([-0.0] * 5)
    assert _bits(_register_combine(vals, "sum")) == _bits(_shuffle_combine(vals, "sum"))
    assert _bits(_register_combine(vals, "sum")) == _bits(np.float32(0.0))
    assert _bits(_register_combine(vals, "min")) == _bits(_shuffle_combine(vals, "min"))


# ------------------------------------------------- the single-lane combine
# segment_combine_kernel (csrc/spmv_ell.cu): a row of at most kGroupRows
# partials is walked by a group of kRowThreads threads, the warp-per-row
# order's accumulator a held by thread a % G as its slot a / G, two batches
# of 32 entries at a time, entries past the row folding the identity; then
# the tree as seen from thread 0 (levels 16 ... G in each thread, the rest
# by shuffles in the group).  A longer row is walked by the whole warp,
# kWarpBatches batches at a time.  The constants are read from the source,
# so the models follow the kernel.
_SPMV_CU = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/spmv_ell.cu"


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SPMV_CU.read_text()).group(1))


ROW_THREADS = _constant("kRowThreads")
GROUP_ROWS = _constant("kGroupRows")
WARP_BATCHES = _constant("kWarpBatches")


def _group_walk(vals, combine):
    """A row walked by its group: thread g's slots, two batches (64
    entries) a step, slot m % S folding entry i0 + g + G m or, past the
    row, the identity; then the in-thread levels and the group's xor
    levels, thread 0's value."""
    fold, ident = _FOLD[combine], _IDENTITY[combine]
    G = ROW_THREADS
    S = 32 // G
    slots = [[ident] * S for _ in range(G)]
    for i0 in range(0, len(vals), 64):
        for g in range(G):
            for m in range(2 * S):
                i = i0 + g + G * m
                slots[g][m % S] = fold(slots[g][m % S], vals[i] if i < len(vals) else ident)
    for g in range(G):
        off = S // 2
        while off:
            for m in range(off):
                slots[g][m] = fold(slots[g][m], slots[g][m + off])
            off //= 2
    v = [slots[g][0] for g in range(G)]
    off = G // 2
    while off:
        v = [fold(v[g], v[g ^ off]) for g in range(G)]
        off //= 2
    return v[0]


def _warp_walk(vals, combine):
    """A long row walked by the whole warp: thread t folds entries t, t +
    32, ..., WARP_BATCHES batches a step, the identity past the row; then
    the xor tree, thread 0's value."""
    fold, ident = _FOLD[combine], _IDENTITY[combine]
    acc = [ident] * 32
    step = 32 * WARP_BATCHES
    for j0 in range(0, len(vals), step):
        for t in range(32):
            for u in range(WARP_BATCHES):
                j = j0 + 32 * u + t
                acc[t] = fold(acc[t], vals[j] if j < len(vals) else ident)
    off = 16
    while off:
        acc = [fold(acc[t], acc[t ^ off]) for t in range(32)]
        off //= 2
    return acc[0]


def _single_lane_kernel(vals, combine):
    return (_group_walk if len(vals) <= GROUP_ROWS else _warp_walk)(vals, combine)


#: rows of 0, 1, 31, 32, 33, 63-65, the group's limit and one either side,
#: and 1,000 partials
LENGTHS = sorted({0, 1, 31, 32, 33, 63, 64, 65, GROUP_ROWS - 1, GROUP_ROWS,
                  GROUP_ROWS + 1, 1000})


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("combine", COMBINES)
def test_single_lane_kernel_is_the_warp_per_row_order(n, combine):
    """Rows of each length through the kernel's model, with -0.0, +-inf
    and NaN among some of them: bitwise the warp-per-row order (the parent
    kernel's), and for min/max on finite and infinite values (no NaN, no
    -0.0) the plain version's; sums within the reference's tolerance."""
    import torch

    from repro_torch.kernels.spmv_ell.kernel import segment_combine_plain

    rng = np.random.default_rng(n + 7)
    special = np.float32([-0.0, 0.0, np.inf, -np.inf, np.nan])
    for r in range(32):
        vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
        pick = rng.random(n) < (0.0, 0.02, 0.2, 1.0)[r % 4]
        vals[pick] = rng.choice(special, int(pick.sum()))
        with np.errstate(invalid="ignore", over="ignore"):
            got = _single_lane_kernel(vals, combine)
            want = _shuffle_combine(vals, combine)
        assert _bits(got) == _bits(want), (r, vals)
        if r % 4:
            continue
        plain = segment_combine_plain(
            torch.from_numpy(vals), [torch.arange(n, dtype=torch.int32)],
            [torch.tensor([0, n], dtype=torch.int32)], combine).numpy()[0]
        if combine == "sum":
            assert np.isclose(got, plain, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(vals).max(initial=0)))
        else:
            assert _bits(got) == _bits(plain)


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 1000, 14284])
def test_single_lane_rows_dealt_once_every_residue(rows):
    """The kernel's deal of a shard's destination rows: warp w owns rows
    w + k * n_warps, k < 32 / kRowThreads, n_warps = ceil(rows / (32 /
    kRowThreads)) rounded up to odd; every row is owned once, and a warp's
    rows take every residue mod 32 / kRowThreads once, so R-MAT's heavy
    rows (many low zero bits) are spread over the warps."""
    per_warp = 32 // ROW_THREADS
    n_warps = -(-rows // per_warp) | 1
    owned = np.add.outer(np.arange(n_warps), np.arange(per_warp) * n_warps)
    assert np.array_equal(np.sort(owned[owned < rows]), np.arange(rows))
    for w in range(n_warps):
        assert sorted(owned[w] % per_warp) == list(range(per_warp))
