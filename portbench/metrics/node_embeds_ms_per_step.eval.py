"""Host milliseconds per rollout step in the policy's node contraction
(``rollout.node_embeds``: ``GMapNavAgent._policy_node_embeds``) in the
window."""

from portbench import rollout_figures


def read(record):
    return rollout_figures.ms_per_step(record, "span_s", "rollout.node_embeds")
