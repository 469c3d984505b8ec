"""Host program: ms per iteration of ``program.pre``, its cast and the
carried-over copy of the values (``IterStats.pre_s``; span ``vsw.pre``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "pre_s")
