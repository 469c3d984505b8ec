"""setup_s: process start to the window's start: CUDA init, the build or
load of the kernels, the graph, the port's preprocessing and store write,
opening the engine, and the warm-up that puts every shard on the card."""


def read(record):
    return record.setup_s
