"""Host milliseconds per navigation step inside the env's calls (reset,
get_obs, teleport) in the window."""

from portbench import readers


def read(record):
    return readers.ms_per(record, "env", "nav_steps")
