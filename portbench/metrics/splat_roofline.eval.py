"""Bytes the traced rollout steps' gather-and-splat calls must move (the
points splatted counted with the reference's lift), at 3.35 TB/s, over the
splat kernels' device time, in %."""

from portbench import readers


def read(record):
    return readers.roofline(record, "splat")
