"""Executor: ms per iteration of dispatch wall time, staging, launches and
the copy back included (``IterStats.exec_s``)."""


def read(record):
    return record.per_iteration_ms(lambda i: i.exec_s)
