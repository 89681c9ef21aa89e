"""Modality encoders (port of ``vln_bevbert_tpu/models/encoders.py``):
language, panorama, global topological map, local BEV map.

Panorama tokens live in fixed slots with a validity mask, views [0:V) then
the objects of REVERIE/SOON [V:V+O); global-map node features arrive
pre-aggregated. A config with the CE depth embedding (``use_depth_embedding``,
``configs/ce_pretrain.json``) builds no ``dep_linear``/``dep_ln``: flax creates
them only when a call passes ``dep_fts``, and no caller of either package does,
so the JAX trees of such configs hold neither.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs import ModelConfig
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
    """Panorama token embedding + pre-norm encoder over the slots
    ``[view_0..view_{V-1} | obj_0..obj_{O-1}]``.

    Object features take their own ``obj_linear``/``obj_ln`` only when their
    width differs from the views'; otherwise they share ``img_linear``/
    ``img_ln``, as the JAX module does. ``token_type_vis`` is the visual
    token-type vector (hidden,) from the shared BertEmbeddings table (type
    id 1)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.img_linear = Dense(cfg, cfg.image_feat_size, hid, device)
        self.img_ln = LayerNorm(cfg, device=device)
        self.loc_linear = Dense(cfg, cfg.angle_feat_size + 3, hid, device)
        self.loc_ln = LayerNorm(cfg, device=device)
        if cfg.obj_feat_size > 0 and cfg.obj_feat_size != cfg.image_feat_size:
            self.obj_linear = Dense(cfg, cfg.obj_feat_size, hid, device)
            self.obj_ln = LayerNorm(cfg, device=device)
        else:
            self.obj_linear = self.obj_ln = None
        # 0: non-navigable view, 1: navigable view, 2: object
        self.nav_type_embedding = Embed(cfg, 3, device)
        self.ln = LayerNorm(cfg, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.pano_layers = _add_layers(self, "pano_layer", cfg.num_pano_layers,
                                       lambda: PanoEncoderLayer(cfg, device))
        self.pano_ln = LayerNorm(cfg, device=device)

    def forward(self, view_fts, loc_fts, nav_types, view_lens, token_type_vis=None,
                obj_fts=None, obj_lens=None, dep_fts=None):
        """view_fts (R, V, Dimg); loc_fts (R, P, A+3) and nav_types (R, P)
        int over P = V + O slots; view_lens (R,); obj_fts (R, O, Dobj) and
        obj_lens (R,) or None. Returns (tokens (R, P, D), masks (R, P) bool).
        ``dep_fts``, the CE depth embedding's input, is refused: no path of
        the port or of the JAX package feeds it."""
        if dep_fts is not None:
            raise NotImplementedError("no path feeds dep_fts: the CE depth embedding "
                                      "(dep_linear, dep_ln) is built by no caller")
        dt = self.dtype
        img = self.img_ln(self.img_linear(view_fts)).to(dt)
        if obj_fts is not None:
            if self.obj_linear is None:
                obj = self.img_ln(self.img_linear(obj_fts)).to(dt)
            else:
                obj = self.obj_ln(self.obj_linear(obj_fts)).to(dt)
            img = torch.cat([img, obj], dim=1)
        x = (
            img
            + self.loc_ln(self.loc_linear(loc_fts)).to(dt)
            + self.nav_type_embedding(nav_types)
        )
        if token_type_vis is not None:
            x = x + token_type_vis.to(dt)[None, None, :]
        x = self.dropout(self.ln(x).to(dt))
        num_view = view_fts.shape[1]
        slot = torch.arange(x.shape[1], device=x.device)[None, :]
        masks = slot < view_lens[:, None]
        if obj_fts is not None:
            masks = masks | ((slot >= num_view) & (slot - num_view < obj_lens[:, None]))
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
    """Metric-map encoder over bev_dim^2 cell tokens, with the object tokens
    (if any) appended as extra keys and queries, cross-modal layers.
    ``lang2visn`` as in ``GlobalMapEncoder``."""

    def __init__(self, cfg: ModelConfig, device=None, lang2visn: bool = False):
        super().__init__()
        self.dtype = _dt(cfg)
        self.num_cells = cfg.num_bev_tokens
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

    def with_objects(self, x, bev_masks, obj_embeds=None, obj_masks=None):
        """The cell tokens and their key masks, with the object tokens and
        masks appended when there are any."""
        if obj_embeds is None:
            return x, bev_masks
        return (torch.cat([x, obj_embeds.to(self.dtype)], dim=1),
                torch.cat([bev_masks, obj_masks], dim=1))

    def forward(self, txt_embeds, txt_masks, bev_fts, bev_pos_fts, bev_masks,
                bev_nav_masks, obj_embeds=None, obj_masks=None):
        """Returns (cell tokens (B, cells, D), object tokens (B, O, D) or None)."""
        x = self.input_embedding(bev_fts, bev_pos_fts, bev_nav_masks)
        x, masks = self.with_objects(x, bev_masks, obj_embeds, obj_masks)
        lang_bias = attn_bias(txt_masks)
        visn_bias = attn_bias(masks)
        for layer in self.x_layers:
            x = layer(x, txt_embeds, lang_bias, visn_bias)
        obj_out = x[:, self.num_cells:] if obj_embeds is not None else None
        return x[:, :self.num_cells], obj_out
