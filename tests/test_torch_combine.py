"""The lane combine's fold order (``csrc/spmv_ell.cu``,
``segment_combine_lanes_kernel``), modelled in numpy in float32 with the
card's fold arithmetic: its 32 accumulators in registers, then the tree as
seen from thread 0, must give the bits of the single-lane combine
(``segment_combine_kernel``): 32 threads, each folding every 32nd entry in
ascending order, then an xor-shuffle tree.  So lane l of the lane combine is
bitwise ``segment_combine`` on lane l, for every combine and any number of
entries a destination row.
"""

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
