"""Share of the traced rollouts' window with no kernel, copy or set on the
card, in %."""

from portbench import readers


def read(record):
    return readers.idle_pct(record)
