"""Scheduler: ms per iteration of the plan (``IterStats.plan_s``, which
is ``ShardPlan.plan_time_s``; span ``sweep.plan``)."""

from perfbench import steps


def read(record):
    return steps.step_ms(record, "plan_s")
