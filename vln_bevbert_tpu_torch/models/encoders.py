"""Modality encoders (port of ``vln_bevbert_tpu/models/encoders.py``):
language, panorama, global topological map, local BEV map.

Panorama tokens live in fixed view slots with a validity mask; global-map
node features arrive pre-aggregated. The object slots of REVERIE/SOON and the
CE depth embedding are not ported yet: a config that asks for them raises.
"""

from __future__ import annotations

import torch
from torch import nn

from vln_bevbert_tpu.configs import ModelConfig

from ..ops.dropout import Dropout
from ..ops.masking import attn_bias
from .bert import BertLayer, BertXLayer, Dense, Embed, LayerNorm, PanoEncoderLayer, _dt


def _add_layers(module: nn.Module, prefix: str, n: int, make) -> list:
    """Register ``n`` layers as ``<prefix>_<i>`` (the flax names)."""
    layers = []
    for i in range(n):
        layer = make()
        module.add_module(f"{prefix}_{i}", layer)
        layers.append(layer)
    return layers


class LanguageEncoder(nn.Module):
    """num_l_layers post-norm BERT layers."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = _add_layers(self, "layer", cfg.num_l_layers,
                                  lambda: BertLayer(cfg, device))

    def forward(self, txt_embeds, txt_masks):
        bias = attn_bias(txt_masks)
        for layer in self.layers:
            txt_embeds = layer(txt_embeds, bias)
        if not self.cfg.update_lang_bert:
            txt_embeds = txt_embeds.detach()
        return txt_embeds


class ImageEmbeddings(nn.Module):
    """Panorama token embedding + pre-norm encoder over view slots [0:V).

    ``token_type_vis`` is the visual token-type vector (hidden,) from the
    shared BertEmbeddings table (type id 1)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.obj_feat_size > 0 or cfg.use_depth_embedding:
            raise NotImplementedError(
                "object tokens and the CE depth embedding are not ported yet"
            )
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.img_linear = Dense(cfg, cfg.image_feat_size, hid, device)
        self.img_ln = LayerNorm(cfg, device=device)
        self.loc_linear = Dense(cfg, cfg.angle_feat_size + 3, hid, device)
        self.loc_ln = LayerNorm(cfg, device=device)
        # 0: non-navigable view, 1: navigable view, 2: object
        self.nav_type_embedding = Embed(cfg, 3, device)
        self.ln = LayerNorm(cfg, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.pano_layers = _add_layers(self, "pano_layer", cfg.num_pano_layers,
                                       lambda: PanoEncoderLayer(cfg, device))
        self.pano_ln = LayerNorm(cfg, device=device)

    def forward(self, view_fts, loc_fts, nav_types, view_lens, token_type_vis=None):
        """view_fts (R, V, Dimg); loc_fts (R, V, A+3); nav_types (R, V) int;
        view_lens (R,). Returns (tokens (R, V, D), masks (R, V) bool)."""
        dt = self.dtype
        x = (
            self.img_ln(self.img_linear(view_fts)).to(dt)
            + self.loc_ln(self.loc_linear(loc_fts)).to(dt)
            + self.nav_type_embedding(nav_types)
        )
        if token_type_vis is not None:
            x = x + token_type_vis.to(dt)[None, None, :]
        x = self.dropout(self.ln(x).to(dt))
        slot = torch.arange(x.shape[1], device=x.device)[None, :]
        masks = slot < view_lens[:, None]
        bias = attn_bias(masks)
        for layer in self.pano_layers:
            x = layer(x, bias)
        return self.pano_ln(x).to(dt), masks


class GlobalMapEncoder(nn.Module):
    """Topological-map encoder: node features + step/pos embeddings, cross-
    modal layers with a learned pairwise-distance attention bias.
    ``lang2visn`` builds the layers' language branch (``BertXLayer``)."""

    def __init__(self, cfg: ModelConfig, device=None, lang2visn: bool = False):
        super().__init__()
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.pos_linear = Dense(cfg, cfg.angle_feat_size + 3, hid, device)
        self.pos_ln = LayerNorm(cfg, device=device)
        self.step_embedding = Embed(cfg, cfg.max_action_steps, device)
        self.x_layers = _add_layers(self, "x_layer", cfg.num_x_layers,
                                    lambda: BertXLayer(cfg, device, lang2visn))
        # 1 -> 1 linear on the pairwise distances
        self.sprel_linear = Dense(cfg, 1, 1, device) if cfg.graph_sprels else None

    def input_embedding(self, gmap_img_fts, gmap_step_ids, gmap_pos_fts):
        dt = self.dtype
        return (
            gmap_img_fts.to(dt)
            + self.step_embedding(gmap_step_ids)
            + self.pos_ln(self.pos_linear(gmap_pos_fts)).to(dt)
        )

    def sprel_bias(self, gmap_pair_dists):
        """(B, N, N) distances -> (B, 1, N, N) float32 bias, or None."""
        if self.sprel_linear is None or gmap_pair_dists is None:
            return None
        b = self.sprel_linear(gmap_pair_dists[..., None].to(self.dtype))
        return b[..., 0][:, None, :, :].float()

    def forward(self, txt_embeds, txt_masks, gmap_img_fts, gmap_step_ids,
                gmap_pos_fts, gmap_masks, gmap_pair_dists=None):
        x = self.input_embedding(gmap_img_fts, gmap_step_ids, gmap_pos_fts)
        lang_bias = attn_bias(txt_masks)
        visn_bias = attn_bias(gmap_masks)
        sprel = self.sprel_bias(gmap_pair_dists)
        for layer in self.x_layers:
            x = layer(x, txt_embeds, lang_bias, visn_bias, sprel)
        return x


class LocalBEVEncoder(nn.Module):
    """Metric-map encoder over bev_dim^2 cell tokens, cross-modal layers.
    Returns the cell tokens (B, cells, D). ``lang2visn`` as in
    ``GlobalMapEncoder``."""

    def __init__(self, cfg: ModelConfig, device=None, lang2visn: bool = False):
        super().__init__()
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.fts_linear = Dense(cfg, cfg.bev_grid_feat_size, hid, device)
        self.fts_ln = LayerNorm(cfg, device=device)
        self.pos_linear = Dense(cfg, cfg.angle_feat_size + 3 + 3, hid, device)
        self.pos_ln = LayerNorm(cfg, device=device)
        # 0: non-navigable cell, 1: candidate cell
        self.nav_type_embedding = Embed(cfg, 2, device)
        self.x_layers = _add_layers(self, "x_layer", cfg.num_x_layers,
                                    lambda: BertXLayer(cfg, device, lang2visn))

    def input_embedding(self, bev_fts, bev_pos_fts, bev_nav_masks):
        dt = self.dtype
        return (
            self.fts_ln(self.fts_linear(bev_fts.to(dt))).to(dt)
            + self.pos_ln(self.pos_linear(bev_pos_fts)).to(dt)
            + self.nav_type_embedding(bev_nav_masks.long())
        )

    def forward(self, txt_embeds, txt_masks, bev_fts, bev_pos_fts, bev_masks,
                bev_nav_masks):
        x = self.input_embedding(bev_fts, bev_pos_fts, bev_nav_masks)
        lang_bias = attn_bias(txt_masks)
        visn_bias = attn_bias(bev_masks)
        for layer in self.x_layers:
            x = layer(x, txt_embeds, lang_bias, visn_bias)
        return x
