"""Host milliseconds per batch inside the loader's batch building
(PretrainLoader.build_batch) in the window."""

from portbench import readers


def read(record):
    return readers.ms_per_call(record, "loader")
