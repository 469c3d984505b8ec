"""Executor: ms per iteration from the accumulators on the device to the
shards' rows on the host, the wait for the kernels included, a part of
``exec_ms`` (``IterStats.copy_back_s``; span ``exec.copy_back``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "copy_back_s")
