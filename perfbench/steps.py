"""The engine's clocked host steps, read from ``IterStats``: each is a
span of ``repro_torch.obs.trace`` and a field of the same clock.  A port
whose ``IterStats`` lacks a field reads as nothing (``None``), not 0."""

from __future__ import annotations

from typing import Optional

__all__ = ["NAMED", "step_ms", "other_ms"]

#: the parts of ``IterStats.time_s`` that a clock names; disjoint, so the
#: rest, ``time_s`` less their sum, is never negative
NAMED = ("exec_s", "load_wait_s", "to_device_s", "plan_s", "pre_s",
         "apply_s", "activity_s")


def _has(record, fields) -> bool:
    return bool(record.iters) and all(hasattr(record.iters[0], f)
                                      for f in fields)


def step_ms(record, field: str) -> Optional[float]:
    """Mean ms per iteration of ``IterStats.<field>``."""
    if not _has(record, (field,)):
        return None
    return record.per_iteration_ms(lambda i: getattr(i, field))


def other_ms(record) -> Optional[float]:
    """Mean ms per iteration of the host time that no clock names:
    ``time_s`` less every field of :data:`NAMED`."""
    if not _has(record, NAMED):
        return None
    return record.per_iteration_ms(
        lambda i: i.time_s - sum(getattr(i, f) for f in NAMED))
