"""The sharded dry run of the hybrid family against the reference: the
widened Jamba smoke config of ``tests/test_dryrun_small.py`` (SSD, MoE and
attention layers) on a (2, 4) fake mesh.

The checks are ``tests/test_torch_dryrun.py``'s for yi-6b
(``tests/_dryrun_parity.py``): rank-0 local shapes equal the reference's
``NamedSharding.shard_shape`` leaf for leaf, argument bytes equal the sum
of those shards (exact), and ``lower_cell``'s terms for ``train_tiny`` and
``decode_tiny`` on (1, 1) and (2, 4).
"""

import pytest

from _dryrun_parity import (DECODE, TRAIN, check_lower_cell,
                            check_shard_shapes_and_argument_bytes, reference)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def ref():
    return reference(ARCH)


@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c[0])
def test_shard_shapes_and_argument_bytes_equal_the_reference(ref, cell):
    check_shard_shapes_and_argument_bytes(ref, ARCH, cell)


@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c[0])
def test_lower_cell_terms(ref, cell):
    check_lower_cell(ref, ARCH, cell)
