"""Bytes the traced replay updates' dropout sites must move, at 3.35 TB/s, over
the dropout kernel's device time, in %."""

from portbench import readers


def read(record):
    return readers.roofline(record, "dropout")
