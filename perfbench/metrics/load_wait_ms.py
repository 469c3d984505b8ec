"""Pipeline: ms per iteration the consumer waited on shard loads
(``IterStats.load_wait_s``)."""


def read(record):
    return record.per_iteration_ms(lambda i: i.load_wait_s)
