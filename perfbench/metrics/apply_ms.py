"""Host program: ms per iteration of ``program.apply`` and its writes,
summed over the shards (``IterStats.apply_s``; spans ``vsw.apply``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "apply_s")
