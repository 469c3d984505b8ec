"""Host program: ms per iteration that no clock names: ``IterStats``
``time_s - exec_s - load_wait_s - to_device_s - plan_s - pre_s - apply_s -
activity_s`` (the bookkeeping, the generators, what the spans miss)."""

from perfbench import steps


def read(record):
    return steps.other_ms(record)
