"""Host milliseconds per step inside the trainer's block step (staging the
inputs, enqueuing the graph replays) in the window."""

from portbench import readers


def read(record):
    return readers.ms_per(record, "dispatch", "steps")
