"""Host program ms per iteration (``IterStats``: ``time_s - exec_s -
load_wait_s - to_device_s``): plan, pre, apply and the vertex arrays."""


def read(record):
    return record.host_ms()
