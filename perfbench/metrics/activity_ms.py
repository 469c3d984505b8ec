"""Host program: ms per iteration of the activity test,
``program.is_active`` and the active ids (``IterStats.activity_s``; span
``vsw.activity``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "activity_s")
