"""preprocess_s: host clock around the port's ``preprocess`` and store
write (``VSWEngine.from_graph`` less the engine's own construction)."""


def read(record):
    return record.preprocess_s
