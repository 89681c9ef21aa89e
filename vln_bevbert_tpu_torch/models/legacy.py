"""Legacy CE baseline policy: Recurrent VLN-BERT (PREVALENT), port of
``vln_bevbert_tpu/models/legacy.py``.

The reference's policy (bevbert_ce/vlnce_baselines/models/vlnbert/
vlnbert_PREVALENT.py:362-447), driven by its "dagger" legacy trainer through
BaseVLNCETrainer's 'VLNBERT' branch (common/base_il_trainer.py:350-470):

- ``language`` mode: BERT embeddings -> ``la_layers`` self-attention layers
  -> pooler; returns (pooled state h_t, sequence embeddings).
- ``visual`` mode: the recurrent step. The state token (slot 0 of the text
  sequence, carried across steps) is concatenated with the candidate visual
  tokens; [state; vision] cross-attends into the remaining language tokens,
  then self-attends, then the FFN runs over the whole [state; vision]
  stream; only slot 0 of the language stream is replaced. The action logits
  are the pre-softmax, post-mask float32 self-attention scores from the state
  row to the vision keys, averaged over heads (vlnbert_PREVALENT.py:322-341,
  446). Masks are additive -10000 float32 biases (``ops/masking.py``), as
  the reference's fp16 mask.

The submodules are named like the flax tree (``embeddings``,
``lalayer_<i>``, ``addlayer_<i>`` with ``cross``/``self_attn``/``inter``/
``out_dense``/``out_ln``, ``pooler``), so ``convert.load_flax_params``
carries JAX parameters across. ``prevalent_to_state_dict`` maps the
reference's torch PREVALENT state dict onto this module's ``state_dict``;
the reference's per-layer language branch (``lang_self_att``/``lang_inter``/
``lang_output``), which its forward never invokes, is dropped.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..ops.dropout import Dropout
from ..ops.masking import attn_bias
from .bert import BertEmbeddings, BertLayer, Dense, LayerNorm, _dt


class ScoredAttention(nn.Module):
    """Multi-head attention (a ``query`` and a fused ``kv`` projection) that
    also returns the pre-softmax scores (post-mask), float32 (B, H, Q, K)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hid = cfg.hidden_size
        self.query = Dense(cfg, hid, hid, device)
        self.kv = Dense(cfg, hid, 2 * hid, device)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob, site="prevalent_attn_probs")

    def forward(self, q_in, kv_in, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        h, d = cfg.num_attention_heads, cfg.head_dim
        dt = _dt(cfg)

        def heads(y):  # (B, L, H*d) -> (B, H, L, d)
            return y.reshape(*y.shape[:-1], h, d).transpose(-3, -2)

        q = heads(self.query(q_in))
        k, v = (heads(t) for t in self.kv(kv_in).chunk(2, dim=-1))
        # the JAX einsum's float32 accumulation of activation-dtype products,
        # then the float32 1/sqrt(d)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
        if bias is not None:
            scores = scores + bias.float()
        probs = self.dropout(torch.softmax(scores, dim=-1).to(dt))
        ctx = torch.matmul(probs, v).to(dt).transpose(-3, -2)
        return ctx.reshape(*ctx.shape[:-2], h * d), scores


class ScoredAttentionBlock(nn.Module):
    """Attention + output dense + residual LayerNorm, returning scores."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.att = ScoredAttention(cfg, device)
        self.out_dense = Dense(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg, device=device)

    def forward(self, q_in, kv_in, bias=None):
        ctx, scores = self.att(q_in, kv_in, bias)
        out = self.dropout(self.out_dense(ctx))
        return self.out_ln(out + q_in).to(self.dtype), scores


class PrevalentXLayer(nn.Module):
    """LXRTXLayer's live branch (vlnbert_PREVALENT.py:291-341): the
    [state; vision] stream cross-attends to language, self-attends, FFN."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.cross = ScoredAttentionBlock(cfg, device)
        self.self_attn = ScoredAttentionBlock(cfg, device)
        self.inter = Dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.out_dense = Dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg, device=device)

    def forward(self, lang, lang_bias, visn, visn_bias):
        # [state; vision]; as jnp.concatenate, a float32 vision input
        # promotes the state token to float32 in this first block
        dt = torch.promote_types(lang.dtype, visn.dtype)
        state_vis = torch.cat([lang[:, :1].to(dt), visn.to(dt)], dim=1)
        sv_bias = torch.cat([lang_bias[..., :1], visn_bias], dim=-1)
        x, cross_scores = self.cross(state_vis, lang[:, 1:], lang_bias[..., 1:])
        x, self_scores = self.self_attn(x, x, sv_bias)
        y = self.out_dense(F.gelu(self.inter(x), approximate="none"))
        x = self.out_ln(self.dropout(y) + x).to(self.dtype)
        new_lang = torch.cat([x[:, :1], lang[:, 1:]], dim=1)
        return new_lang, x[:, 1:], cross_scores[:, :, 0, :], self_scores[:, :, 0, 1:]


class RecurrentVLNBert(nn.Module):
    """Mode-dispatched PREVALENT policy core."""

    def __init__(self, cfg: ModelConfig, la_layers: int = 9, vl_layers: int = 4, device=None):
        super().__init__()
        self.la_layers, self.vl_layers = la_layers, vl_layers
        self.embeddings = BertEmbeddings(cfg, device)
        for i in range(la_layers):
            setattr(self, f"lalayer_{i}", BertLayer(cfg, device))
        for i in range(vl_layers):
            setattr(self, f"addlayer_{i}", PrevalentXLayer(cfg, device))
        self.pooler = Dense(cfg, cfg.hidden_size, cfg.hidden_size, device)

    def pool(self, seq: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.pooler(seq[:, 0]))

    def language(self, txt_ids, txt_masks):
        x = self.embeddings(txt_ids)
        bias = attn_bias(txt_masks)
        for i in range(self.la_layers):
            x = getattr(self, f"lalayer_{i}")(x, bias)
        return self.pool(x), x

    def visual(self, lang_embeds, txt_masks, img_feats, vis_masks):
        """``lang_embeds`` carries h_t in slot 0 (the caller substitutes it
        each step, base_il_trainer.py:455-456). Returns (h_t_new,
        action_scores (B, K) float32)."""
        lang_bias, visn_bias = attn_bias(txt_masks), attn_bias(vis_masks)
        lang, visn = lang_embeds, img_feats
        visual_scores = None
        for i in range(self.vl_layers):
            lang, visn, _, visual_scores = getattr(self, f"addlayer_{i}")(
                lang, lang_bias, visn, visn_bias)
        return self.pool(lang), visual_scores.mean(dim=1)

    def forward(self, mode: str, batch: Mapping[str, Any]):
        if mode == "language":
            return self.language(batch["txt_ids"], batch["txt_masks"])
        if mode == "visual":
            return self.visual(batch["lang_embeds"], batch["txt_masks"], batch["img_feats"],
                               batch["vis_masks"])
        raise ValueError(f"unknown mode: {mode}")


def prevalent_to_tree(state_dict: Mapping[str, Any], la_layers: int = 9,
                      vl_layers: int = 4) -> Dict[str, Any]:
    """A torch PREVALENT VLNBert state dict as the flax-layout tree of
    ``RecurrentVLNBert`` (numpy): strips the ``module.`` / ``vln_bert.`` /
    ``bert.`` prefixes the reference's loaders strip, fuses qkv (language
    layers) and kv (cross-modal layers), drops the unused ``lang_*``
    entries."""
    sd = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "vln_bert.", "bert."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        sd[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def lin(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def fused(prefixes):
        parts = [lin(p) for p in prefixes]
        return {"kernel": np.concatenate([p["kernel"] for p in parts], 1),
                "bias": np.concatenate([p["bias"] for p in parts])}

    def scored_block(att, out):
        return {"att": {"query": lin(f"{att}.query"),
                        "kv": fused([f"{att}.key", f"{att}.value"])},
                "out_dense": lin(f"{out}.dense"), "out_ln": ln(f"{out}.LayerNorm")}

    tree: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
            "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
            "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
            "ln": ln("embeddings.LayerNorm"),
        },
        "pooler": lin("pooler.dense"),
    }
    for i in range(la_layers):
        p = f"lalayer.{i}"
        tree[f"lalayer_{i}"] = {
            "attn": {
                "att": {"qkv": fused([f"{p}.attention.self.{n}"
                                      for n in ("query", "key", "value")])},
                "out_dense": lin(f"{p}.attention.output.dense"),
                "out_ln": ln(f"{p}.attention.output.LayerNorm"),
            },
            "ffn": {
                "inter": lin(f"{p}.intermediate.dense"),
                "out_dense": lin(f"{p}.output.dense"),
                "out_ln": ln(f"{p}.output.LayerNorm"),
            },
        }
    for i in range(vl_layers):
        p = f"addlayer.{i}"
        tree[f"addlayer_{i}"] = {
            "cross": scored_block(f"{p}.visual_attention.att", f"{p}.visual_attention.output"),
            "self_attn": scored_block(f"{p}.visn_self_att.self", f"{p}.visn_self_att.output"),
            "inter": lin(f"{p}.visn_inter.dense"),
            "out_dense": lin(f"{p}.visn_output.dense"),
            "out_ln": ln(f"{p}.visn_output.LayerNorm"),
        }
    return tree


def prevalent_to_state_dict(state_dict: Mapping[str, Any], la_layers: int = 9,
                            vl_layers: int = 4) -> Dict[str, torch.Tensor]:
    """``prevalent_to_tree`` as a ``RecurrentVLNBert`` state dict (float32)."""
    from ..convert import flax_to_state_dict

    return flax_to_state_dict(prevalent_to_tree(state_dict, la_layers, vl_layers))
