"""Percent of the memory bound that the single-lane partials kernels reach:
``roofline.partials_bytes`` of each whole sweep over their device time in
the trace."""

from perfbench import record as rec
from perfbench import roofline


def read(record):
    return record.roofline_pct(rec.PARTIALS_KERNELS, roofline.partials_bytes)
