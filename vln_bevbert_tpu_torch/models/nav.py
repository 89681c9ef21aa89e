"""Navigation-time model (port of ``vln_bevbert_tpu/models/nav.py``): a
mode-dispatched per-step model, 'language' once per episode, 'panorama' and
'navigation' once per action step. The pretraining backbone is the ``bert``
submodule, as in the JAX package. ``Critic`` is the state-value head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..ops.dropout import Dropout
from ..ops.masking import masked_fill_neg
from .bert import Dense, TwoLayerHead
from .glocal import GlocalTextPathCMT, sap_logits

Batch = Dict[str, Any]


class Critic(nn.Module):
    """State-value head (ref map_nav_src/models/model.py:41-55; constructed
    by the reference agent for RL fine-tuning, unused under pure IL):
    Dropout -> fc1 (512) + ReLU -> Dropout -> fc2 (1), squeezed. Both
    dropouts are the port's ``Dropout``, the seeded dropout kernel on the
    card in training mode. ``in_features`` is the state's width (flax infers
    it; by default the hidden size)."""

    def __init__(self, cfg: ModelConfig, in_features: Optional[int] = None,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.drop_state = Dropout(dropout, site="critic_state")
        self.fc1 = Dense(cfg, in_features or cfg.hidden_size, 512, device)
        self.drop_hidden = Dropout(dropout, site="critic_hidden")
        self.fc2 = Dense(cfg, 512, 1, device)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(self.drop_state(state)))
        return self.fc2(self.drop_hidden(x))[..., 0]


class GlocalTextPathNavCMT(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hid = cfg.hidden_size
        self.bert = GlocalTextPathCMT(cfg, device)
        self.global_sap_head = TwoLayerHead(cfg, 1, device=device)
        if cfg.use_bev:
            self.local_sap_head = TwoLayerHead(cfg, 1, device=device)
        self.sap_fuse_linear = (
            TwoLayerHead(cfg, 1, in_features=2 * hid, device=device)
            if cfg.glocal_fuse and cfg.use_bev else None
        )
        # REVERIE/SOON: object grounding over the local branch's object tokens
        self.og_head = (TwoLayerHead(cfg, 1, device=device)
                        if cfg.obj_feat_size > 0 and cfg.use_bev else None)

    # ---------------------------------------------------------------- modes
    def forward_text(self, txt_ids, txt_masks):
        return self.bert.encode_text(txt_ids, txt_masks)

    def forward_panorama_per_step(self, view_fts, loc_fts, nav_types, view_lens,
                                  obj_fts=None, obj_lens=None):
        """Single-step pano encoding -> (pano_embeds (B, P, D), pano_masks)."""
        return self.bert.img_embeddings(
            view_fts, loc_fts, nav_types, view_lens, self.bert.token_type_vis(),
            obj_fts, obj_lens,
        )

    def forward_navigation_per_step(self, batch: Batch) -> Dict[str, Any]:
        """Batch keys: txt_embeds (B,L,D), txt_masks, gmap_img_embeds (B,N,D),
        gmap_step_ids, gmap_pos_fts, gmap_masks, gmap_pair_dists,
        gmap_visited_masks, bev_fts (B,C,768), bev_pos_fts, bev_masks,
        bev_nav_masks, bev_cand_idxs (B,K), local_masks (B,K), fuse_map (B,N,K),
        and with objects obj_embeds (B,O,D), obj_masks (B,O).
        """
        cfg = self.cfg
        txt_embeds, txt_masks = batch["txt_embeds"], batch["txt_masks"]
        gmap_embeds = self.bert.global_encoder(
            txt_embeds, txt_masks, batch["gmap_img_embeds"], batch["gmap_step_ids"],
            batch["gmap_pos_fts"], batch["gmap_masks"], batch["gmap_pair_dists"],
        )

        if not cfg.use_bev:
            # topo-only navigation: the global branch alone scores the nodes
            global_logits = self.global_sap_head(gmap_embeds)[..., 0]
            global_logits = masked_fill_neg(global_logits, batch["gmap_visited_masks"])
            global_logits = masked_fill_neg(global_logits, ~batch["gmap_masks"])
            return {
                "gmap_embeds": gmap_embeds, "global_logits": global_logits,
                "fused_logits": global_logits, "local_logits": None,
                "bev_embeds": None, "obj_logits": None, "fuse_weights": 1.0,
            }

        bev_embeds, obj_embeds = self.bert.encode_bev(
            txt_embeds, batch, batch.get("obj_embeds"), batch.get("obj_masks"))
        global_logits, local_logits, fused_logits, fuse_weights = sap_logits(
            self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
            cfg.bev_center, gmap_embeds, bev_embeds, batch,
        )
        obj_logits = None
        if obj_embeds is not None and self.og_head is not None:
            obj_logits = masked_fill_neg(self.og_head(obj_embeds)[..., 0], ~batch["obj_masks"])
        return {
            "gmap_embeds": gmap_embeds, "bev_embeds": bev_embeds,
            "global_logits": global_logits, "local_logits": local_logits,
            "fused_logits": fused_logits, "obj_logits": obj_logits,
            "fuse_weights": fuse_weights,
        }

    def forward(self, mode: str, batch: Batch):
        if mode == "language":
            return self.forward_text(batch["txt_ids"], batch["txt_masks"])
        if mode == "panorama":
            return self.forward_panorama_per_step(
                batch["view_fts"], batch["loc_fts"], batch["nav_types"],
                batch["view_lens"], batch.get("obj_fts"), batch.get("obj_lens"),
            )
        if mode == "navigation":
            return self.forward_navigation_per_step(batch)
        raise ValueError(f"unknown mode: {mode}")
