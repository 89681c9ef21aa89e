"""Frozen CLIP ViT vision tower (port of ``vln_bevbert_tpu/models/clip.py``).

The reference runs OpenAI CLIP frozen for the offline feature pipeline and
the live CE policy (resnet_encoders.py:280-, CLIPEncoderB16). This is the
JAX package's tower in PyTorch: patch conv, class token, learned positions,
pre-LN transformer with a fused QKV projection, quick-GELU MLP. Parameter
names follow the flax tree (``convert.py`` maps one onto the other), and
``hf_clip_to_state_dict`` maps a HuggingFace ``CLIPVisionModel`` state dict
onto them.

Numerics follow the JAX module: activations in ``dtype`` (float32 by
default, as the JAX tower's); LayerNorm eps 1e-5 with float32 statistics,
cast back to ``dtype``; attention scores in float32 (JAX's
``preferred_element_type``), the softmax in float32, probabilities cast
back. Matmuls are plain ``F.linear``/``torch.matmul`` and the patch
embedding ``F.conv2d``: in JAX they are ``nn.Dense``, ``einsum`` and
``nn.Conv``, outside any Pallas kernel. On the card the patch conv runs in
strict float32 only with ``torch.backends.cudnn.allow_tf32 = False``, which
``cli/ce_train.py`` sets (cuDNN's default is TF32).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# CLIP image normalisation constants (OpenAI)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# OpenAI CLIP's rule for a ViT's heads (clip/model.py build_model)
HEAD_WIDTH = 64


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


class ClipVisionTower(nn.Module):
    """Input: (B, H, W, 3) normalised images, as the JAX module takes them.
    Returns ``pooled`` (B, D), the post-LN class token, and ``grid`` (B, P,
    D), the final layer's patch tokens (the reference's 14x14 grid features
    at H=W=224, patch 16)."""

    def __init__(self, hidden_size: int = 768, intermediate_size: int = 3072,
                 num_layers: int = 12, num_heads: int = 12, patch_size: int = 16,
                 image_size: int = 224, dtype: str = "float32", device=None):
        super().__init__()
        d = hidden_size
        self.hidden_size, self.num_heads, self.patch_size = d, num_heads, patch_size
        self.num_layers = num_layers
        self.dtype = getattr(torch, dtype)
        n_patches = (image_size // patch_size) ** 2
        self.patch_embedding = nn.Conv2d(3, d, patch_size, stride=patch_size, bias=False,
                                         device=device)
        self.class_embedding = nn.Parameter(torch.empty(d, device=device))
        self.position_embedding = nn.Parameter(torch.empty(n_patches + 1, d, device=device))
        self.pre_ln = nn.LayerNorm(d, eps=1e-5, device=device)
        for i in range(num_layers):
            setattr(self, f"ln1_{i}", nn.LayerNorm(d, eps=1e-5, device=device))
            setattr(self, f"qkv_{i}", nn.Linear(d, 3 * d, device=device))
            setattr(self, f"attn_out_{i}", nn.Linear(d, d, device=device))
            setattr(self, f"ln2_{i}", nn.LayerNorm(d, eps=1e-5, device=device))
            setattr(self, f"fc1_{i}", nn.Linear(d, intermediate_size, device=device))
            setattr(self, f"fc2_{i}", nn.Linear(intermediate_size, d, device=device))
        self.post_ln = nn.LayerNorm(d, eps=1e-5, device=device)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, name)
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        dt, d = self.dtype, self.hidden_size
        b = images.shape[0]
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.patch_embedding.weight.to(dt),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, P, D), patches in row-major order
        cls = self.class_embedding.to(dt).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)[None]
        x = _ln(self.pre_ln, x).to(dt)
        for i in range(self.num_layers):
            x = self._layer(x, i)
        pooled = _ln(self.post_ln, x[:, 0, :]).to(dt)
        return {"pooled": pooled, "grid": x[:, 1:, :]}

    def _layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        dt, d, heads = self.dtype, self.hidden_size, self.num_heads
        hd = d // heads
        b, n = x.shape[:2]
        y = _ln(getattr(self, f"ln1_{i}"), x).to(dt)
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)
                   for t in self._dense(f"qkv_{i}", y).split(d, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
        x = x + self._dense(f"attn_out_{i}", ctx)
        y = _ln(getattr(self, f"ln2_{i}"), x).to(dt)
        y = self._dense(f"fc2_{i}", quick_gelu(self._dense(f"fc1_{i}", y)))
        return x + y


def tower_config(state_dict: Mapping[str, Any]) -> Dict[str, int]:
    """``ClipVisionTower`` widths read off a state dict in its layout, as
    OpenAI CLIP's ``build_model`` reads them (heads = width // 64)."""
    hidden = state_dict["position_embedding"].shape[1]
    patch = state_dict["patch_embedding.weight"].shape[-1]
    side = math.isqrt(state_dict["position_embedding"].shape[0] - 1)
    layers = sum(1 for k in state_dict if re.fullmatch(r"qkv_\d+\.weight", k))
    return {"hidden_size": hidden, "intermediate_size": state_dict["fc1_0.weight"].shape[0],
            "num_layers": layers, "num_heads": max(hidden // HEAD_WIDTH, 1),
            "patch_size": patch, "image_size": side * patch}


def hf_clip_to_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A HuggingFace ``CLIPVisionModel`` state dict -> a ``ClipVisionTower``
    state dict (fused QKV), the counterpart of JAX's ``hf_clip_to_tree``.
    Torch layouts carry over unchanged; the layer count is read off the
    keys (JAX's remap takes it as an argument, 12 by default)."""
    sd = {k.replace("vision_model.", ""): torch.as_tensor(np.asarray(v, np.float32))
          for k, v in state_dict.items()}
    out = {"patch_embedding.weight": sd["embeddings.patch_embedding.weight"],
           "class_embedding": sd["embeddings.class_embedding"],
           "position_embedding": sd["embeddings.position_embedding.weight"]}

    def copy(dst: str, src: str):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    copy("pre_ln", "pre_layrnorm")  # sic: HF's typo'd key
    copy("post_ln", "post_layernorm")
    layers = sum(1 for k in sd if re.fullmatch(r"encoder\.layers\.\d+\.mlp\.fc1\.weight", k))
    for i in range(layers):
        p = f"encoder.layers.{i}"
        qkv = [f"{p}.self_attn.{n}_proj" for n in ("q", "k", "v")]
        out[f"qkv_{i}.weight"] = torch.cat([sd[f"{n}.weight"] for n in qkv])
        out[f"qkv_{i}.bias"] = torch.cat([sd[f"{n}.bias"] for n in qkv])
        copy(f"attn_out_{i}", f"{p}.self_attn.out_proj")
        copy(f"ln1_{i}", f"{p}.layer_norm1")
        copy(f"ln2_{i}", f"{p}.layer_norm2")
        copy(f"fc1_{i}", f"{p}.mlp.fc1")
        copy(f"fc2_{i}", f"{p}.mlp.fc2")
    return out


def preprocess(images_uint8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> normalised float32."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD
