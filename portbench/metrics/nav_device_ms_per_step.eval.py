"""Device milliseconds per rollout step of the agent's three model forwards,
from the stamps of the device phases ``nav.language``, ``nav.panorama`` and
``nav.navigation`` in the window."""

from portbench import rollout_figures


def read(record):
    return rollout_figures.ms_per_step(record, "phase_s", "nav.")
