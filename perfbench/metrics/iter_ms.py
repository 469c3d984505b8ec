"""iter_ms: the window's wall time over the engine iterations completed in
it (whole requests only)."""


def read(record):
    if not record.iterations:
        return None
    return 1e3 * record.window_s / record.iterations
