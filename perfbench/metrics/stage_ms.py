"""Executor: ms per iteration staging the messages, the pinned buffer
and its copy to the device, a part of ``exec_ms`` (``IterStats.stage_s``;
span ``exec.stage``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "stage_s")
