"""Percent of the host link's bound that the host-to-device copies reach:
``transfer.sweep_bytes`` of each whole sweep (4 B per edge, 4 B per
vertex with an in-edge) at 64 GB/s, over the device time of every
``Memcpy HtoD`` in the trace."""

from perfbench import transfer


def read(record):
    return transfer.share_pct(record)
