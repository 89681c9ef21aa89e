"""Navigation-time model (port of ``vln_bevbert_tpu/models/nav.py:51-183``):
a mode-dispatched per-step model, 'language' once per episode, 'panorama'
and 'navigation' once per action step. The pretraining backbone is the
``bert`` submodule, as in the JAX package. ``Critic`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from ..configs import ModelConfig
from ..ops.masking import masked_fill_neg
from .bert import TwoLayerHead
from .glocal import GlocalTextPathCMT, sap_logits

Batch = Dict[str, Any]


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

    # ---------------------------------------------------------------- modes
    def forward_text(self, txt_ids, txt_masks):
        return self.bert.encode_text(txt_ids, txt_masks)

    def forward_panorama_per_step(self, view_fts, loc_fts, nav_types, view_lens):
        """Single-step pano encoding -> (pano_embeds (B, V, D), pano_masks)."""
        return self.bert.img_embeddings(
            view_fts, loc_fts, nav_types, view_lens,
            token_type_vis=self.bert.token_type_vis(),
        )

    def forward_navigation_per_step(self, batch: Batch) -> Dict[str, Any]:
        """Batch keys: txt_embeds (B,L,D), txt_masks, gmap_img_embeds (B,N,D),
        gmap_step_ids, gmap_pos_fts, gmap_masks, gmap_pair_dists,
        gmap_visited_masks, bev_fts (B,C,768), bev_pos_fts, bev_masks,
        bev_nav_masks, bev_cand_idxs (B,K), local_masks (B,K), fuse_map (B,N,K).
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
                "bev_embeds": None, "fuse_weights": 1.0,
            }

        bev_embeds = self.bert.encode_bev(txt_embeds, batch)
        global_logits, local_logits, fused_logits, fuse_weights = sap_logits(
            self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
            cfg.bev_center, gmap_embeds, bev_embeds, batch,
        )
        return {
            "gmap_embeds": gmap_embeds, "bev_embeds": bev_embeds,
            "global_logits": global_logits, "local_logits": local_logits,
            "fused_logits": fused_logits, "fuse_weights": fuse_weights,
        }

    def forward(self, mode: str, batch: Batch):
        if mode == "language":
            return self.forward_text(batch["txt_ids"], batch["txt_masks"])
        if mode == "panorama":
            return self.forward_panorama_per_step(
                batch["view_fts"], batch["loc_fts"], batch["nav_types"],
                batch["view_lens"],
            )
        if mode == "navigation":
            return self.forward_navigation_per_step(batch)
        raise ValueError(f"unknown mode: {mode}")
