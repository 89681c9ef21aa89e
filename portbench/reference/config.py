"""The reference's view of a configuration file: the model and shape
settings as attributes, with the sizes derived from them."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict


class ModelSettings(SimpleNamespace):
    @property
    def num_bev_tokens(self) -> int:
        return self.bev_dim * self.bev_dim

    @property
    def bev_center(self) -> int:
        return (self.bev_dim * self.bev_dim - 1) // 2


class ShapeSettings(SimpleNamespace):
    @property
    def num_points(self) -> int:
        return self.num_views * self.grid_hw * self.grid_hw


def settings(run: Dict[str, Any]):
    """(model, shapes) of a configuration's ``run`` block."""
    return ModelSettings(**run["model"]), ShapeSettings(**run["shapes"])
