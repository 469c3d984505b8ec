"""Percent of the traced window in which no operation ran on the card."""


def read(record):
    return record.idle_pct()
