"""Percent of the memory bound that the single-lane segment combine
reaches: ``roofline.combine_bytes`` of each whole sweep over its device
time in the trace."""

from perfbench import record as rec
from perfbench import roofline


def read(record):
    return record.roofline_pct(rec.COMBINE_KERNELS, roofline.combine_bytes)
