from .geometry_ce import (
    estimate_cand_pos,
    heading_from_quaternion,
    quaternion_from_heading,
    rel_pos_features_ce,
)
from .graph_map import CEGraphMap

__all__ = [
    "heading_from_quaternion",
    "quaternion_from_heading",
    "estimate_cand_pos",
    "rel_pos_features_ce",
    "CEGraphMap",
]
