"""Wall milliseconds per replay update in the window, up to its loss readback
(a wrapper around GMapNavAgent._learn)."""

from portbench import readers


def read(record):
    return readers.ms_per_call(record, "update")
