"""The glocal (global topo-map + local BEV-map) cross-modal backbone
(port of ``vln_bevbert_tpu/models/glocal.py:57-168``).

The pretraining heads and losses (``GlocalTextPathCMTPreTraining``) and the
object tokens are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from vln_bevbert_tpu.configs import ModelConfig

from .bert import BertEmbeddings, _dt
from .encoders import GlobalMapEncoder, ImageEmbeddings, LanguageEncoder, LocalBEVEncoder

Batch = Dict[str, Any]


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, L, D), idx: (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[-1]))


class GlocalTextPathCMT(nn.Module):
    """Backbone: text encoder + pano encoder + global/local map encoders."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        self.lang_encoder = LanguageEncoder(cfg, device)
        self.img_embeddings = ImageEmbeddings(cfg, device)
        # the topo-only variant (use_bev=False) has no local branch
        self.local_encoder = LocalBEVEncoder(cfg, device) if cfg.use_bev else None
        self.global_encoder = GlobalMapEncoder(cfg, device)

    def token_type_vis(self) -> torch.Tensor:
        return self.embeddings.token_type_embeddings.weight[1]

    def encode_text(self, txt_ids, txt_masks):
        return self.lang_encoder(self.embeddings(txt_ids), txt_masks)

    def encode_pano(self, batch: Batch):
        """Returns (pano_embeds (B, T, V, D), pano_masks (B, T, V))."""
        vf = batch["traj_view_fts"]
        b, t = vf.shape[:2]
        flat = lambda x: x.reshape(b * t, *x.shape[2:])
        x, masks = self.img_embeddings(
            flat(vf), flat(batch["traj_loc_fts"]), flat(batch["traj_nav_types"]),
            flat(batch["traj_view_lens"]), token_type_vis=self.token_type_vis(),
        )
        v = x.shape[1]
        return x.reshape(b, t, v, -1), masks.reshape(b, t, v)

    def aggregate_gmap(self, pano_embeds, pano_masks, gmap_agg):
        """Node features = host-weighted sums of trajectory tokens.
        pano_embeds (B, T, V, D); gmap_agg (B, N, T*V)."""
        dt = _dt(self.cfg)
        b, t, v, d = pano_embeds.shape
        tokens = (pano_embeds * pano_masks[..., None]).reshape(b, t * v, d)
        out = torch.matmul(gmap_agg.to(dt).float(), tokens.float())
        return out.to(dt)

    def forward(self, batch: Batch, return_gmap_embeds: bool = True):
        """Returns (gmap_embeds or None, bev_embeds or None)."""
        txt_embeds = self.encode_text(batch["txt_ids"], batch["txt_masks"])
        pano_embeds, pano_masks = self.encode_pano(batch)
        gmap_embeds = None
        if return_gmap_embeds:
            gmap_img_fts = self.aggregate_gmap(pano_embeds, pano_masks, batch["gmap_agg"])
            gmap_embeds = self.global_encoder(
                txt_embeds, batch["txt_masks"], gmap_img_fts,
                batch["gmap_step_ids"], batch["gmap_pos_fts"],
                batch["gmap_masks"], batch["gmap_pair_dists"],
            )
        bev_embeds = None
        if self.local_encoder is not None:
            bev_embeds = self.local_encoder(
                txt_embeds, batch["txt_masks"], batch["bev_fts"],
                batch["bev_pos_fts"], batch["bev_masks"], batch["bev_nav_masks"],
            )
        return gmap_embeds, bev_embeds
