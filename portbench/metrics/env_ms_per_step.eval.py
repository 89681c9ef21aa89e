"""Host milliseconds per rollout step inside the env's own calls (the spans
``env.reset``, ``env.get_obs`` and ``env.teleport``, each less what nests
in it) in the window."""

from portbench import rollout_figures


def read(record):
    return rollout_figures.ms_per_step(record, "self_s", "env.")
