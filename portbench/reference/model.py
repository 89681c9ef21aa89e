"""The plain reference of the glocal cross-modal model: its pretraining heads
and losses, and the per-step navigation model of DAgger fine-tuning.

A frozen copy of ``vln_bevbert_tpu_torch/models/{bert,encoders,glocal,nav}.py``
written as plain ``torch`` operations: no kernel, no graph, no cache. The
parameter names are the program's, so that one set of weights loads into
both. It follows the program's equations (post-norm BERT layers, pre-norm
panorama layers, the -10000 mask bias, exact GELU, float32 LayerNorm and
softmax, the distance bias on the global map, the gated fusion of global and
local action logits) and computes them in the precision ``Numerics`` gives:

- ``Numerics()``: float32 everywhere, the reference that decides
  ``correct`` (TF32 is switched off by the caller);
- ``Numerics(torch.bfloat16)``: the program's stated precision, bfloat16
  activations over float32 parameters, used by ``counts.py`` to find the
  bytes the program's dropout sites move;
- ``Numerics(torch.bfloat16, fp8=True)``: the control, one precision below
  the stated one: every dense layer as an fp8 training recipe computes it
  (input and weight through float8 e4m3, the incoming gradient through e5m2,
  each at a per-tensor scale).

Dropout draws one seed per leading row from the generator it is handed, in
the program's order, and keeps an element iff its Philox4x32-10 bits pass
the threshold (``dropout.py``), so that the reference drops what the
program drops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import seeded_dropout

Batch = Dict[str, Any]
NEG_INF = -10000.0


@dataclass(frozen=True)
class Numerics:
    """Activation dtype, and whether dense inputs and weights go through fp8."""

    dtype: torch.dtype = torch.float32
    fp8: bool = False


def _fp8(x: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded through ``dtype`` at a per-tensor scale (its amax to the
    format's largest value), back in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = torch.finfo(dtype).max / amax
    return ((x.detach().float() * scale).to(dtype).float() / scale).to(x.dtype)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3; the gradient passes straight through."""
    return x + (_fp8(x) - x).detach()


class _Fp8Linear(torch.autograd.Function):
    """``x @ w.T + b`` as an fp8 training recipe computes it: the input and
    the weight rounded through e4m3, the incoming gradient through e5m2,
    each at a per-tensor scale; products accumulate in the activation dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _fp8(gy, torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return gx, gw, gy.reshape(-1, gy.shape[-1]).sum(0)


def attn_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) bool key mask -> (B, 1, 1, L) float32 additive bias."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def masked_fill_neg(x: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    return x.masked_fill(invalid, NEG_INF)


class Dropout(nn.Module):
    """Seeded dropout of a rank >= 2 input: one seed per leading row drawn
    from ``generator``; identity in eval mode. ``hook``, when set, is called
    with each call's input and output (``counts.py`` counts the bytes)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.hook = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        seeds = torch.randint(-2 ** 31, 2 ** 31, (x.shape[0],), generator=self.generator,
                              device=x.device, dtype=torch.int32)
        y = seeded_dropout(x.contiguous(), seeds, self.rate)
        if self.hook is not None:
            self.hook(x, y)
        return y


def set_generator(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Dense(nn.Module):
    def __init__(self, num: Numerics, n_in: int, n_out: int):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        dt = self.num.dtype
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if self.num.fp8 and x.device.type != "meta":
            return _Fp8Linear.apply(x, w, b)
        return F.linear(x, w, b)


class Embed(nn.Module):
    def __init__(self, num: Numerics, n: int, hidden: int):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(n, hidden))

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight).to(self.num.dtype)


class LayerNorm(nn.Module):
    def __init__(self, cfg, features: Optional[int] = None):
        super().__init__()
        features = features or cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps)


class Attention(nn.Module):
    def __init__(self, cfg, num: Numerics, cross: bool = False):
        super().__init__()
        self.cfg, self.num, self.cross = cfg, num, cross
        hid = cfg.hidden_size
        if cross:
            self.query = Dense(num, hid, hid)
            self.kv = Dense(num, hid, 2 * hid)
        else:
            self.qkv = Dense(num, hid, 3 * hid)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)
        head_dim = hid // cfg.num_attention_heads
        self.scale = torch.tensor(1.0 / math.sqrt(head_dim), dtype=num.dtype, device="cpu").item()

    def forward(self, q_in, kv_in, bias=None):
        h = self.cfg.num_attention_heads
        d = self.cfg.hidden_size // h
        dt = self.num.dtype

        def heads(y):
            return y.reshape(*y.shape[:-1], h, d).transpose(-3, -2)

        if self.cross:
            q = heads(self.query(q_in))
            k, v = (heads(t) for t in self.kv(kv_in).chunk(2, dim=-1))
        else:
            q, k, v = (heads(t) for t in self.qkv(q_in).chunk(3, dim=-1))
        scores = torch.matmul(q * self.scale, k.transpose(-1, -2))
        if bias is not None:
            scores = scores + bias.to(dt)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        probs = self.dropout(probs)
        ctx = torch.matmul(probs, v).to(dt).transpose(-3, -2)
        return ctx.reshape(*ctx.shape[:-2], h * d)


class AttentionBlock(nn.Module):
    def __init__(self, cfg, num: Numerics, cross: bool = False):
        super().__init__()
        self.num = num
        self.att = Attention(cfg, num, cross)
        self.out_dense = Dense(num, cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg)

    def forward(self, q_in, kv_in, bias=None):
        out = self.dropout(self.out_dense(self.att(q_in, kv_in, bias)))
        return self.out_ln(out + q_in).to(self.num.dtype)


class Ffn(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.num = num
        self.inter = Dense(num, cfg.hidden_size, cfg.intermediate_size)
        self.out_dense = Dense(num, cfg.intermediate_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg)

    def forward(self, x):
        y = self.out_dense(F.gelu(self.inter(x), approximate="none"))
        return self.out_ln(self.dropout(y) + x).to(self.num.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.attn = AttentionBlock(cfg, num)
        self.ffn = Ffn(cfg, num)

    def forward(self, x, bias=None):
        return self.ffn(self.attn(x, x, bias))


class BertXLayer(nn.Module):
    def __init__(self, cfg, num: Numerics, lang2visn: bool = False):
        super().__init__()
        self.cross = AttentionBlock(cfg, num, cross=True)
        self.self_attn = AttentionBlock(cfg, num)
        self.ffn = Ffn(cfg, num)
        if lang2visn:
            self.lang_self_attn = AttentionBlock(cfg, num)
            self.lang_ffn = Ffn(cfg, num)

    def forward(self, visn, lang, lang_bias, visn_bias, sprel_bias=None):
        x = self.cross(visn, lang, lang_bias)
        bias = visn_bias if sprel_bias is None else visn_bias + sprel_bias
        return self.ffn(self.self_attn(x, x, bias))

    def lang2visn(self, lang, visn, visn_bias, lang_bias):
        x = self.cross(lang, visn, visn_bias)
        x = self.lang_self_attn(x, x, lang_bias)
        return self.lang_ffn(x)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.word_embeddings = Embed(num, cfg.vocab_size, hid)
        self.position_embeddings = Embed(num, cfg.max_position_embeddings, hid)
        self.token_type_embeddings = Embed(num, cfg.type_vocab_size, hid)
        self.ln = LayerNorm(cfg)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, ids):
        pos = torch.arange(ids.shape[-1], device=ids.device)[None, :]
        x = self.word_embeddings(ids) + self.position_embeddings(pos)
        x = x + self.token_type_embeddings(torch.zeros_like(ids))
        return self.dropout(self.ln(x).to(self.num.dtype))


class PanoEncoderLayer(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.ln1 = LayerNorm(cfg)
        self.att = Attention(cfg, num)
        self.att_out = Dense(num, hid, hid)
        self.ln2 = LayerNorm(cfg)
        self.inter = Dense(num, hid, cfg.intermediate_size)
        self.out_dense = Dense(num, cfg.intermediate_size, hid)
        self.drop_att = Dropout(cfg.hidden_dropout_prob)
        self.drop_inter = Dropout(cfg.hidden_dropout_prob)
        self.drop_out = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, bias=None):
        dt = self.num.dtype
        y = self.ln1(x).to(dt)
        x = x + self.drop_att(self.att_out(self.att(y, y, bias)))
        y = self.ln2(x).to(dt)
        y = self.drop_inter(F.gelu(self.inter(y), approximate="none"))
        return x + self.drop_out(self.out_dense(y))


class MlmHead(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.num = num
        self.transform = Dense(num, cfg.hidden_size, cfg.hidden_size)
        self.transform_ln = LayerNorm(cfg)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size))

    def forward(self, hidden, tied):
        x = F.gelu(self.transform(hidden), approximate="none")
        x = self.transform_ln(x).to(self.num.dtype)
        return torch.matmul(x.float(), tied.to(self.num.dtype).float().T) + self.bias.float()


class TwoLayerHead(nn.Module):
    def __init__(self, cfg, num: Numerics, out_dim: int = 1, in_features: Optional[int] = None):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.fc1 = Dense(num, in_features or hid, hid)
        self.ln = LayerNorm(cfg)
        self.fc2 = Dense(num, hid, out_dim)

    def forward(self, x):
        return self.fc2(self.ln(F.relu(self.fc1(x))).to(self.num.dtype)).float()


def _layers(module: nn.Module, prefix: str, n: int, make) -> list:
    out = []
    for i in range(n):
        layer = make()
        module.add_module(f"{prefix}_{i}", layer)
        out.append(layer)
    return out


class LanguageEncoder(nn.Module):
    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.layers = _layers(self, "layer", cfg.num_l_layers, lambda: BertLayer(cfg, num))

    def forward(self, x, masks):
        bias = attn_bias(masks)
        for layer in self.layers:
            x = layer(x, bias)
        return x


class ImageEmbeddings(nn.Module):
    """Panorama tokens (views only: no object slots in these cells)."""

    def __init__(self, cfg, num: Numerics):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.img_linear = Dense(num, cfg.image_feat_size, hid)
        self.img_ln = LayerNorm(cfg)
        self.loc_linear = Dense(num, cfg.angle_feat_size + 3, hid)
        self.loc_ln = LayerNorm(cfg)
        self.nav_type_embedding = Embed(num, 3, hid)
        self.ln = LayerNorm(cfg)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.pano_layers = _layers(self, "pano_layer", cfg.num_pano_layers,
                                   lambda: PanoEncoderLayer(cfg, num))
        self.pano_ln = LayerNorm(cfg)

    def forward(self, view_fts, loc_fts, nav_types, view_lens, token_type_vis):
        dt = self.num.dtype
        x = (self.img_ln(self.img_linear(view_fts)).to(dt)
             + self.loc_ln(self.loc_linear(loc_fts)).to(dt)
             + self.nav_type_embedding(nav_types))
        x = x + token_type_vis.to(dt)[None, None, :]
        x = self.dropout(self.ln(x).to(dt))
        masks = torch.arange(x.shape[1], device=x.device)[None, :] < view_lens[:, None]
        bias = attn_bias(masks)
        for layer in self.pano_layers:
            x = layer(x, bias)
        return self.pano_ln(x).to(dt), masks


class GlobalMapEncoder(nn.Module):
    def __init__(self, cfg, num: Numerics, lang2visn: bool = False):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.pos_linear = Dense(num, cfg.angle_feat_size + 3, hid)
        self.pos_ln = LayerNorm(cfg)
        self.step_embedding = Embed(num, cfg.max_action_steps, hid)
        self.x_layers = _layers(self, "x_layer", cfg.num_x_layers,
                                lambda: BertXLayer(cfg, num, lang2visn))
        self.sprel_linear = Dense(num, 1, 1)

    def input_embedding(self, img, step_ids, pos_fts):
        dt = self.num.dtype
        return (img.to(dt) + self.step_embedding(step_ids)
                + self.pos_ln(self.pos_linear(pos_fts)).to(dt))

    def forward(self, txt, txt_masks, img, step_ids, pos_fts, masks, pair_dists):
        x = self.input_embedding(img, step_ids, pos_fts)
        lang_bias, visn_bias = attn_bias(txt_masks), attn_bias(masks)
        sprel = self.sprel_linear(pair_dists[..., None].to(self.num.dtype))[..., 0][:, None].float()
        for layer in self.x_layers:
            x = layer(x, txt, lang_bias, visn_bias, sprel)
        return x


class LocalBEVEncoder(nn.Module):
    def __init__(self, cfg, num: Numerics, lang2visn: bool = False):
        super().__init__()
        self.num = num
        hid = cfg.hidden_size
        self.fts_linear = Dense(num, cfg.bev_grid_feat_size, hid)
        self.fts_ln = LayerNorm(cfg)
        self.pos_linear = Dense(num, cfg.angle_feat_size + 6, hid)
        self.pos_ln = LayerNorm(cfg)
        self.nav_type_embedding = Embed(num, 2, hid)
        self.x_layers = _layers(self, "x_layer", cfg.num_x_layers,
                                lambda: BertXLayer(cfg, num, lang2visn))

    def input_embedding(self, fts, pos_fts, nav_masks):
        dt = self.num.dtype
        return (self.fts_ln(self.fts_linear(fts.to(dt))).to(dt)
                + self.pos_ln(self.pos_linear(pos_fts)).to(dt)
                + self.nav_type_embedding(nav_masks.long()))

    def forward(self, txt, txt_masks, fts, pos_fts, masks, nav_masks):
        x = self.input_embedding(fts, pos_fts, nav_masks)
        lang_bias, visn_bias = attn_bias(txt_masks), attn_bias(masks)
        for layer in self.x_layers:
            x = layer(x, txt, lang_bias, visn_bias)
        return x


class Backbone(nn.Module):
    """Text, panorama, global-map and local-BEV encoders (``bert``)."""

    def __init__(self, cfg, num: Numerics, lang2visn: bool = False):
        super().__init__()
        self.num = num
        self.embeddings = BertEmbeddings(cfg, num)
        self.lang_encoder = LanguageEncoder(cfg, num)
        self.img_embeddings = ImageEmbeddings(cfg, num)
        self.local_encoder = LocalBEVEncoder(cfg, num, lang2visn)
        self.global_encoder = GlobalMapEncoder(cfg, num, lang2visn)

    def encode_text(self, ids, masks):
        return self.lang_encoder(self.embeddings(ids), masks)

    def encode_pano_rows(self, view_fts, loc_fts, nav_types, view_lens):
        tt = self.embeddings.token_type_embeddings.weight[1]
        return self.img_embeddings(view_fts, loc_fts, nav_types, view_lens, tt)

    def encode_pano(self, batch: Batch):
        vf = batch["traj_view_fts"]
        b, t = vf.shape[:2]
        flat = lambda x: x.reshape(b * t, *x.shape[2:])
        x, masks = self.encode_pano_rows(flat(vf), flat(batch["traj_loc_fts"]),
                                         flat(batch["traj_nav_types"]),
                                         flat(batch["traj_view_lens"]))
        return x.reshape(b, t, x.shape[1], -1), masks.reshape(b, t, -1)

    def aggregate_gmap(self, pano, masks, agg):
        b, t, v, d = pano.shape
        tokens = (pano * masks[..., None]).reshape(b, t * v, d)
        return torch.matmul(agg.to(self.num.dtype).float(), tokens.float()).to(self.num.dtype)

    def encode_bev(self, txt, batch: Batch):
        return self.local_encoder(txt, batch["txt_masks"], batch["bev_fts"],
                                  batch["bev_pos_fts"], batch["bev_masks"],
                                  batch["bev_nav_masks"])

    def forward(self, batch: Batch):
        txt = self.encode_text(batch["txt_ids"], batch["txt_masks"])
        pano, masks = self.encode_pano(batch)
        gmap = self.global_encoder(txt, batch["txt_masks"],
                                   self.aggregate_gmap(pano, masks, batch["gmap_agg"]),
                                   batch["gmap_step_ids"], batch["gmap_pos_fts"],
                                   batch["gmap_masks"], batch["gmap_pair_dists"])
        return gmap, self.encode_bev(txt, batch)

    def forward_mlm(self, batch: Batch):
        txt = self.encode_text(batch["txt_ids"], batch["txt_masks"])
        pano, masks = self.encode_pano(batch)
        lang_bias = attn_bias(batch["txt_masks"])
        gmap_in = self.global_encoder.input_embedding(
            self.aggregate_gmap(pano, masks, batch["gmap_agg"]),
            batch["gmap_step_ids"], batch["gmap_pos_fts"])
        gmap_bias = attn_bias(batch["gmap_masks"])
        g = txt
        for layer in self.global_encoder.x_layers:
            g = layer.lang2visn(g, gmap_in, gmap_bias, lang_bias)
        bev_in = self.local_encoder.input_embedding(batch["bev_fts"], batch["bev_pos_fts"],
                                                    batch["bev_nav_masks"])
        bev_bias = attn_bias(batch["bev_masks"])
        l = txt
        for layer in self.local_encoder.x_layers:
            l = layer.lang2visn(l, bev_in, bev_bias, lang_bias)
        return g + l

    def forward_sem(self, batch: Batch):
        """The 'cattn' cell embeddings: the full cross-modal local branch."""
        return self.encode_bev(self.encode_text(batch["txt_ids"], batch["txt_masks"]), batch)


def sap_logits(global_head, local_head, fuse_linear, bev_center, gmap, bev, batch: Batch):
    w = torch.sigmoid(fuse_linear(torch.cat([gmap[:, 0], bev[:, bev_center]], -1)))
    g = global_head(gmap)[..., 0] * w
    g = masked_fill_neg(masked_fill_neg(g, batch["gmap_visited_masks"]), ~batch["gmap_masks"])
    idx = batch["bev_cand_idxs"].long()[:, :, None].expand(-1, -1, bev.shape[-1])
    l = local_head(torch.gather(bev, 1, idx))[..., 0] * (1.0 - w)
    l = masked_fill_neg(l, ~batch["local_masks"])
    safe = torch.where(batch["local_masks"], l, torch.zeros_like(l))
    fused = g + torch.einsum("bnk,bk->bn", batch["fuse_map"].float(), safe)
    return g, l, fused


def cross_entropy(logits, labels, ignore_index: int = -100):
    """Per-row float32 NLL with an ignore label: (loss (B,), valid (B,))."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(torch.log_softmax(logits.float(), -1), -1, safe[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


class PretrainModel(nn.Module):
    """Backbone and the mlm / sap / masksem heads; ``forward(batch, task)``
    -> scalar loss (the program's normalisations)."""

    def __init__(self, cfg, tasks: Tuple[str, ...], num: Numerics = Numerics()):
        super().__init__()
        self.cfg, self.num = cfg, num
        hid = cfg.hidden_size
        self.bert = Backbone(cfg, num, lang2visn="mlm" in tasks)
        self.feat_dropout = Dropout(cfg.feat_dropout)
        if "mlm" in tasks:
            self.mlm_head = MlmHead(cfg, num)
        if "sap" in tasks:
            self.global_sap_head = TwoLayerHead(cfg, num)
            self.local_sap_head = TwoLayerHead(cfg, num)
            self.sap_fuse_linear = TwoLayerHead(cfg, num, in_features=2 * hid)
        if {"sem", "masksem"} & set(tasks):
            self.local_sem_head = TwoLayerHead(cfg, num, cfg.num_sem_classes)

    def forward(self, batch: Batch, task: str) -> torch.Tensor:
        batch = dict(batch)
        for key in ("traj_view_fts", "bev_fts"):
            batch[key] = self.feat_dropout(batch[key])
        return getattr(self, f"loss_{task}")(batch)

    def loss_mlm(self, batch):
        txt = self.bert.forward_mlm(batch)
        idx = batch["mlm_pos"].long()[:, :, None].expand(-1, -1, txt.shape[-1])
        logits = self.mlm_head(torch.gather(txt, 1, idx),
                               self.bert.embeddings.word_embeddings.weight)
        b, m, v = logits.shape
        tgt = batch["mlm_tgt"].reshape(-1).long()
        labels = torch.where(batch["mlm_valid"].reshape(-1), tgt, torch.full_like(tgt, -100))
        loss, valid = cross_entropy(logits.reshape(b * m, v), labels)
        return loss.sum() / valid.sum().clamp_min(1)

    def loss_sap(self, batch):
        gmap, bev = self.bert(batch)
        g, l, f = sap_logits(self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
                             self.cfg.bev_center, gmap, bev, batch)
        gl, ll = batch["global_act_labels"].long(), batch["local_act_labels"].long()
        loss = cross_entropy(g, gl)[0] + cross_entropy(l, ll)[0] + cross_entropy(f, gl)[0]
        return loss.sum() / gl.shape[0]

    def _sem_loss(self, bev, batch, sel):
        logits = self.local_sem_head(bev)
        labels = batch["bev_sems"].float()
        bce = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
        n = sel.sum().clamp_min(1)
        return torch.where(sel[..., None], bce, torch.zeros_like(bce)).sum() / (n * labels.shape[-1])

    def loss_masksem(self, batch):
        masked = dict(batch)
        masked["bev_fts"] = torch.where(batch["bev_mrc_masks"][..., None],
                                        torch.zeros_like(batch["bev_fts"]), batch["bev_fts"])
        return self._sem_loss(self.bert.forward_sem(masked), batch,
                              batch["bev_sem_masks"] & batch["bev_mrc_masks"])


class NavModel(nn.Module):
    """Backbone and the navigation heads (``GlocalTextPathNavCMT``)."""

    def __init__(self, cfg, num: Numerics = Numerics()):
        super().__init__()
        self.cfg, self.num = cfg, num
        self.bert = Backbone(cfg, num)
        self.global_sap_head = TwoLayerHead(cfg, num)
        self.local_sap_head = TwoLayerHead(cfg, num)
        self.sap_fuse_linear = TwoLayerHead(cfg, num, in_features=2 * cfg.hidden_size)

    def navigation(self, batch: Batch) -> torch.Tensor:
        """Fused action logits (B, N) of one step, float32."""
        gmap = self.bert.global_encoder(
            batch["txt_embeds"], batch["txt_masks"], batch["gmap_img_embeds"],
            batch["gmap_step_ids"], batch["gmap_pos_fts"], batch["gmap_masks"],
            batch["gmap_pair_dists"])
        bev = self.bert.encode_bev(batch["txt_embeds"], batch)
        return sap_logits(self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
                          self.cfg.bev_center, gmap, bev, batch)[2]


def init_kind(name: str, param: torch.Tensor, module: nn.Module) -> str:
    """How the program initialises a parameter (flax's initialisers):
    "normal" (dense kernels, embeddings), "zeros" (biases), "ones"
    (LayerNorm scales)."""
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(owner, LayerNorm):
        return "ones" if leaf == "weight" else "zeros"
    return "normal" if leaf == "weight" else "zeros"


def decayed(name: str) -> bool:
    """The program's weight-decay rule on a parameter's path: no biases, and
    nothing under a module named ``ln``, ``*_ln`` or ``LayerNorm``."""
    parts = name.split(".")
    return parts[-1] != "bias" and not any(
        p == "ln" or p.endswith("_ln") or p == "LayerNorm" for p in parts[:-1])
