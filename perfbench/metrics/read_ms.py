"""Storage: ms per iteration of the store reads and cache gets, summed
over the prefetch threads (``IterStats.read_s``; spans ``shard.read``
and ``cache.get``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "read_s")
