"""Model FLOPs of the traced window's pretraining steps (counted from each
batch's unpadded shapes over the reference's forward and backward) over the
traced wall seconds times the H100's 989 TFLOP/s bf16 peak, in %."""

from portbench import readers


def read(record):
    return readers.mfu(record)
