"""Pipeline: ms per iteration of the shards' copies to the card and their
combine order, on the consumer's thread, where the iteration waits for
them (``IterStats.to_device_s``; span ``shard.to_device``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "to_device_s")
