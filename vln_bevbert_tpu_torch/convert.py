"""Flax parameter tree <-> the port's ``state_dict``.

The port's modules mirror the flax module names, so a parameter path maps
one to one; only the leaves differ:

- flax ``Dense.kernel`` (in, out)   <-> ``Dense.weight`` (out, in), transposed;
- flax ``Dense.bias``               <-> ``Dense.bias``;
- flax ``Embed.embedding``          <-> ``Embed.weight``;
- flax ``LayerNorm.scale``/``bias`` <-> ``LayerNorm.weight``/``bias``;
- the MLM head's own ``bias`` stays ``bias``.

Fused projections (``qkv``, ``kv``) stay fused. The tree is nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``); a gradient tree has the
same shape and converts the same way. This module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .models.bert import Dense, Embed, LayerNorm, MlmHead

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


def _flax_leaves(mod: nn.Module):
    """(flax leaf name, torch attribute) pairs of a parameter-owning module."""
    if isinstance(mod, Dense):
        return (("kernel", "weight"), ("bias", "bias"))
    if isinstance(mod, Embed):
        return (("embedding", "weight"),)
    if isinstance(mod, LayerNorm):
        return (("scale", "weight"), ("bias", "bias"))
    if isinstance(mod, MlmHead):  # its own vocab bias beside its submodules
        return (("bias", "bias"),)
    return ()


def flax_paths(module: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """``{parameter name: flax path}``, e.g. ``"out_ln.weight"`` ->
    ``("out_ln", "scale")``, for every parameter of ``module``."""
    out: Dict[str, Tuple[str, ...]] = {}
    for mod_name, mod in module.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        for leaf, attr in _flax_leaves(mod):
            out[".".join(prefix + (attr,))] = prefix + (leaf,)
    own = {name for name, _ in module.named_parameters()}
    if set(out) != own:
        raise KeyError(f"parameters without a flax path: {sorted(own - set(out))}")
    return out


def module_to_flax(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a flax-shaped tree of float32 numpy arrays."""
    params = dict(module.named_parameters())
    tree: Dict[str, Any] = {}
    for name, path in flax_paths(module).items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        val = params[name].detach().float().cpu()
        node[path[-1]] = (val.T if path[-1] == "kernel" else val).numpy().copy()
    return tree
