"""Flax parameter tree <-> the port's ``state_dict``.

The port's modules mirror the flax module names, so a parameter path maps
one to one; only the leaves differ:

- flax ``Dense.kernel`` (in, out)   <-> ``Dense.weight`` (out, in), transposed
  (also ``nn.Linear``);
- flax ``Conv.kernel`` (kH, kW, I, O) <-> ``nn.Conv2d.weight`` (O, I, kH, kW):
  axes (3, 2, 0, 1), so each filter keeps its spatial layout (a plain ``.T``
  would give (O, I, kW, kH): every filter transposed in space);
- flax ``Dense.bias``/``Conv.bias`` <-> ``bias``;
- flax ``Embed.embedding``          <-> ``Embed.weight``;
- flax ``LayerNorm``/``GroupNorm`` ``scale``/``bias`` <-> ``weight``/``bias``;
- the MLM head's own ``bias`` stays ``bias``; a module's raw parameters
  (``RAW_LEAVES``: CLIP's ``class_embedding`` and ``position_embedding``)
  keep their names and layouts.

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

RAW_LEAVES = ("class_embedding", "position_embedding")
_LEAF_TO_TORCH = {"kernel": "weight", "embedding": "weight", "scale": "weight",
                  "bias": "bias", **{k: k for k in RAW_LEAVES}}


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """flax kernel -> torch weight: (in, out) -> (out, in); (kH, kW, I, O)
    -> (O, I, kH, kW)."""
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def _kernel_to_flax(arr: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_kernel_to_torch``."""
    return arr.permute(2, 3, 1, 0) if arr.dim() == 4 else arr.T


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
                arr = _kernel_to_torch(arr)
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
    if isinstance(mod, (Dense, nn.Linear, nn.Conv2d)):
        return (("kernel", "weight"),) + ((("bias", "bias"),) if mod.bias is not None else ())
    if isinstance(mod, Embed):
        return (("embedding", "weight"),)
    if isinstance(mod, (LayerNorm, nn.LayerNorm, nn.GroupNorm)):
        return (("scale", "weight"), ("bias", "bias"))
    if isinstance(mod, MlmHead):  # its own vocab bias beside its submodules
        return (("bias", "bias"),)
    return tuple((name, name) for name, _ in mod.named_parameters(recurse=False)
                 if name in RAW_LEAVES)


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
        node[path[-1]] = (_kernel_to_flax(val) if path[-1] == "kernel" else val).numpy().copy()
    return tree
