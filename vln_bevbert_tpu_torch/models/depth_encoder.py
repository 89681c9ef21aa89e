"""DDPPO depth encoder: GroupNorm ResNet-50 + compression head (port of
``vln_bevbert_tpu/models/depth_encoder.py``).

The frozen depth tower the reference loads from a DDPPO point-nav
checkpoint (bevbert_ce/vlnce_baselines/models/encoders/resnet_encoders.py:
13-108, wrapping habitat-baselines' ddppo ResNetEncoder): input average
pool /2, 7x7/2 stem, GroupNorm(baseplanes/2 groups) everywhere, bottleneck
stages [3, 4, 6, 3] with planes 32/64/128/256 (expansion 4), a -inf-padded
3x3/2 max pool after the stem, then a 3x3 stride-1 compression conv with
GroupNorm(1) sized so that the flattened output is
``after_compression_flat_size``: (128, 4, 4) for the 256x256 VLN-CE depth
sensor. Convolutions pad symmetrically, as torch and the JAX module do.

Parameter names follow the flax tree (``conv1``, ``bn1``,
``layer{s}_{b}.conv_0`` ... ``ds_gn``, ``compression_conv``,
``compression_gn``); ``load_ddppo_ckpt`` performs the reference's key
surgery onto them. The module takes (B, H, W[, 1]) depth as the JAX module
does and returns NCHW (B, C, h, w), the layout the waypoint predictor
flattens; JAX returns NHWC (B, h, w, C). The torch module needs the input
size at construction: its compression width depends on the final spatial
size, which the JAX module reads at call time. Convolutions are
``F.conv2d`` (JAX: ``nn.Conv``, no Pallas kernel); on the card they run in
strict float32 only with ``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _gn(ngroups: int, channels: int, device=None) -> nn.GroupNorm:
    # torch GroupNorm eps (habitat uses the default 1e-5)
    return nn.GroupNorm(ngroups, channels, eps=1e-5, device=device)


class Bottleneck(nn.Module):
    """habitat-baselines ddppo resnet Bottleneck: 1x1 -> 3x3(stride) -> 1x1
    with GroupNorm after each conv, residual downsample when shapes change."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, ngroups: int = 16,
                 expansion: int = 4, device=None):
        super().__init__()
        out_ch = planes * expansion
        self.conv_0 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.gn_1 = _gn(ngroups, planes, device)
        self.conv_3 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                                device=device)
        self.gn_4 = _gn(ngroups, planes, device)
        self.conv_6 = nn.Conv2d(planes, out_ch, 1, bias=False, device=device)
        self.gn_7 = _gn(ngroups, out_ch, device)
        self.downsample = inplanes != out_ch or stride != 1
        if self.downsample:
            self.ds_conv = nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False,
                                     device=device)
            self.ds_gn = _gn(ngroups, out_ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn_1(self.conv_0(x)))
        y = F.relu(self.gn_4(self.conv_3(y)))
        y = self.gn_7(self.conv_6(y))
        if self.downsample:
            x = self.ds_gn(self.ds_conv(x))
        return F.relu(x + y)


def final_spatial(input_size: int, num_stages: int) -> int:
    """The side of the tower's output for an ``input_size`` square frame:
    the average pool, the stem, the max pool, and each later stage halve
    it (rounding up, but the pool down)."""
    s = input_size // 2
    for _ in range(2 + num_stages - 1):
        s = (s - 1) // 2 + 1
    return s


class DdppoDepthEncoder(nn.Module):
    """(B, H, W[, 1]) depth in [0, 1] -> (B, C, H/64, W/64) spatial features
    ((128, 4, 4) for the reference's 256x256 depth frames)."""

    def __init__(self, baseplanes: int = 32, layers: Sequence[int] = (3, 4, 6, 3),
                 after_compression_flat_size: int = 2048, input_size: int = 256, device=None):
        super().__init__()
        ngroups = baseplanes // 2
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(1, baseplanes, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = _gn(ngroups, baseplanes, device)
        inplanes, planes = baseplanes, baseplanes
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        Bottleneck(inplanes, planes, stride, ngroups, device=device))
                inplanes = planes * 4
            if stage < len(self.layers) - 1:
                planes *= 2
        spatial = final_spatial(input_size, len(self.layers))
        channels = int(round(after_compression_flat_size / spatial ** 2))
        self.feat_shape: Tuple[int, int, int] = (channels, spatial, spatial)
        self.compression_conv = nn.Conv2d(inplanes, channels, 3, padding=1, bias=False,
                                          device=device)
        self.compression_gn = _gn(1, channels, device)

    def forward(self, depth: torch.Tensor) -> torch.Tensor:
        if depth.dim() == 4:  # (B, H, W, 1)
            depth = depth[..., 0]
        x = F.avg_pool2d(depth[:, None].float(), 2)  # ResNetEncoder.forward starts so
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        return F.relu(self.compression_gn(self.compression_conv(x)))


def encoder_config(state_dict: Mapping[str, Any], input_size: int = 256) -> Dict[str, Any]:
    """``DdppoDepthEncoder`` arguments read off a state dict in its layout
    for ``input_size`` square frames: the stem's width, the blocks per stage,
    and the flat size of the compression conv's output."""
    blocks: Dict[int, int] = {}
    for k in state_dict:
        m = re.fullmatch(r"layer(\d+)_(\d+)\.conv_0\.weight", k)
        if m:
            stage = int(m.group(1))
            blocks[stage] = max(blocks.get(stage, 0), int(m.group(2)) + 1)
    layers = tuple(blocks[s] for s in sorted(blocks))
    channels = state_dict["compression_conv.weight"].shape[0]
    return {"baseplanes": state_dict["conv1.weight"].shape[0], "layers": layers,
            "after_compression_flat_size": channels * final_spatial(input_size, len(layers)) ** 2,
            "input_size": input_size}


def load_ddppo_ckpt(ckpt: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """DDPPO point-nav checkpoint -> ``DdppoDepthEncoder`` state dict.

    Accepts the raw torch checkpoint dict (a ``state_dict`` entry whose keys
    start ``actor_critic.net.visual_encoder.``, the layout the reference
    strips at resnet_encoders.py:39-50) or an already-stripped
    ``{backbone.*, compression.*}`` dict. Torch layouts carry over. The
    blocks per stage are read off the keys (JAX's remap takes them as an
    argument, (3, 4, 6, 3) by default)."""
    sd_in = ckpt.get("state_dict", ckpt)
    sd: Dict[str, torch.Tensor] = {}
    for k, v in sd_in.items():
        parts = k.split(".")
        if "visual_encoder" in parts:
            parts = parts[parts.index("visual_encoder") + 1:]
        sd[".".join(parts)] = torch.as_tensor(np.asarray(v, np.float32))

    out: Dict[str, torch.Tensor] = {}

    def conv(dst: str, src: str):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]

    def gn(dst: str, src: str):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]

    conv("conv1", "backbone.conv1")
    gn("bn1", "backbone.bn1")
    conv("compression_conv", "compression.0")
    gn("compression_gn", "compression.1")
    pattern = re.compile(r"backbone\.layer(\d+)\.(\d+)\.convs\.0\.weight")
    blocks = sorted((int(m.group(1)), int(m.group(2))) for m in map(pattern.fullmatch, sd) if m)
    for stage, b in blocks:
        p, q = f"backbone.layer{stage}.{b}", f"layer{stage}_{b}"
        for i, name in ((0, "conv_0"), (3, "conv_3"), (6, "conv_6")):
            conv(f"{q}.{name}", f"{p}.convs.{i}")
        for i, name in ((1, "gn_1"), (4, "gn_4"), (7, "gn_7")):
            gn(f"{q}.{name}", f"{p}.convs.{i}")
        if f"{p}.downsample.0.weight" in sd:
            conv(f"{q}.ds_conv", f"{p}.downsample.0")
            gn(f"{q}.ds_gn", f"{p}.downsample.1")
    return out
