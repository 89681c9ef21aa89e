"""Flax parameter tree <-> the port's ``state_dict``.

The port's modules mirror the flax module names, so a parameter path maps
one to one; only the leaves differ:

- flax ``Dense.kernel`` (in, out)   <-> ``Dense.weight`` (out, in), transposed;
- flax ``Dense.bias``               <-> ``Dense.bias``;
- flax ``Embed.embedding``          <-> ``Embed.weight``;
- flax ``LayerNorm.scale``/``bias`` <-> ``LayerNorm.weight``/``bias``.

Fused projections (``qkv``, ``kv``) stay fused. The tree is nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``); this module imports no
JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .models.bert import Dense, Embed, LayerNorm

_LEAF_TO_TORCH = {"kernel": "weight", "embedding": "weight", "scale": "weight",
                  "bias": "bias"}


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into ``{dotted.name: tensor}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            if key not in _LEAF_TO_TORCH:
                raise KeyError(f"unknown flax parameter leaf: {prefix}{key}")
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                arr = arr.T
            out[prefix + _LEAF_TO_TORCH[key]] = torch.tensor(arr)

    walk(tree, "")
    return out


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Load a flax param tree into ``module``.

    Raises if a flax parameter has no place in the module, a module
    parameter has no flax value, or a shape differs."""
    sd = flax_to_state_dict(tree)
    own = module.state_dict()
    unused, missing = sorted(set(sd) - set(own)), sorted(set(own) - set(sd))
    if unused or missing:
        raise KeyError(
            f"flax tree does not match {type(module).__name__}: "
            f"unused flax params {unused}, module params without a value {missing}"
        )
    for name, val in sd.items():
        if tuple(val.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: flax shape {tuple(val.shape)} vs module {tuple(own[name].shape)}"
            )
    module.load_state_dict(sd)


def module_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a flax-shaped tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for mod_name, mod in module.named_modules():
        if isinstance(mod, Dense):
            leaves = {"kernel": mod.weight.T, "bias": mod.bias}
        elif isinstance(mod, Embed):
            leaves = {"embedding": mod.weight}
        elif isinstance(mod, LayerNorm):
            leaves = {"scale": mod.weight, "bias": mod.bias}
        else:
            continue
        node = tree
        for part in mod_name.split(".") if mod_name else []:
            node = node.setdefault(part, {})
        for leaf, val in leaves.items():
            node[leaf] = val.detach().float().cpu().numpy().copy()
    return tree
