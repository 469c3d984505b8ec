"""Storage: ms per iteration of the shards' host decode, the npz parse
and the mask unpack, summed over the prefetch threads
(``IterStats.decode_s``; span ``shard.decode``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "decode_s")
