"""Edge cache: percent of the shard bytes loaded in the window that the
byte cache served, ``100 * sum(cache_bytes) / sum(cache_bytes +
bytes_read)`` over ``IterStats``; nothing where no shard was loaded
(every shard resident) or the port does not count ``cache_bytes``."""


def read(record):
    if not record.iters or not hasattr(record.iters[0], "cache_bytes"):
        return None
    served = sum(i.cache_bytes for i in record.iters)
    total = served + sum(i.bytes_read for i in record.iters)
    return 100.0 * served / total if total else None
