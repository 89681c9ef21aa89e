"""Host milliseconds per rollout step inside the rollout's own spans
(``rollout.*``, each less what nests in it: the env's calls), without the
waits for the device (``rollout.readback``), in the window."""

from portbench import rollout_figures


def read(record):
    return rollout_figures.ms_per_step(record, "self_s", "rollout.",
                                       leave_out=("rollout.readback",))
