"""Model FLOPs of the traced rollouts' forwards (language, panorama and
navigation, counted from their shapes over the reference) over the traced
wall seconds times the H100's 989 TFLOP/s bf16 peak, in %."""

from portbench import readers


def read(record):
    return readers.mfu(record)
