"""Bytes the traced pretraining steps' BEV splats must move, at 3.35 TB/s, over
the splat kernels' device time, in %."""

from portbench import readers


def read(record):
    return readers.roofline(record, "splat")
