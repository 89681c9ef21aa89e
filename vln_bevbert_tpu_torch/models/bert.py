"""BERT-family building blocks (port of ``vln_bevbert_tpu/models/bert.py``).

Parameter names mirror the flax tree (``convert.py`` maps one onto the
other): ``Dense`` holds ``weight`` (out, in) and ``bias`` where flax holds
``kernel`` (in, out) and ``bias``; ``Embed.weight`` is flax's ``embedding``;
``LayerNorm.weight`` is flax's ``scale``.

Numerics follow the JAX package:

- parameters are stored in ``cfg.param_dtype``; dense layers and embeddings
  compute in the activation dtype ``cfg.dtype`` ("float32" for parity tests,
  "bfloat16" on the card);
- LayerNorm runs in float32 (eps ``cfg.layer_norm_eps``) and returns float32;
  callers cast to the activation dtype, as the JAX modules do;
- attention scores are in the activation dtype, the softmax in float32, the
  probabilities are cast back, and the context is a matmul with float32
  accumulation (cuBLAS's for bf16) rounded to the activation dtype;
- GELU is exact (erf).

Attention is written as explicit ``torch.matmul`` + softmax, like the JAX
einsums. The JAX modules' ``deterministic`` flag is the module's eval mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..ops.dropout import Dropout


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: inputs, weight and bias cast to the activation dtype."""

    def __init__(self, cfg: ModelConfig, in_features: int, out_features: int,
                 device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.init_std = cfg.initializer_range
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=_pdt(cfg), device=device)
        )
        self.bias = nn.Parameter(torch.empty(out_features, dtype=_pdt(cfg), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of the table, in the activation dtype."""

    def __init__(self, cfg: ModelConfig, num: int, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.init_std = cfg.initializer_range
        self.weight = nn.Parameter(
            torch.empty(num, cfg.hidden_size, dtype=_pdt(cfg), device=device)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics and output in float32."""

    def __init__(self, cfg: ModelConfig, features: Optional[int] = None, device=None):
        super().__init__()
        features = features or cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        self.weight = nn.Parameter(torch.empty(features, dtype=_pdt(cfg), device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=_pdt(cfg), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter as the flax initialisers do: dense kernels
    and embeddings ~ N(0, initializer_range), biases 0, LayerNorm scale 1.
    ``generator`` must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (Dense, Embed)):
            m.weight.normal_(0.0, m.init_std, generator=generator)
        if isinstance(m, (Dense, MlmHead)):
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class Attention(nn.Module):
    """Multi-head attention with an additive bias.

    Self-attention (``cross=False``) projects with one fused ``qkv`` dense;
    cross-attention projects ``query`` from ``q_in`` and a fused ``kv`` from
    ``kv_in``. The JAX module picks the form by ``q_in is kv_in`` at call
    time; a torch module must own its parameters from construction."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        hid = cfg.hidden_size
        if cross:
            self.query = Dense(cfg, hid, hid, device)
            self.kv = Dense(cfg, hid, 2 * hid, device)
        else:
            self.qkv = Dense(cfg, hid, 3 * hid, device)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob, site="attn_probs")
        # 1/sqrt(d) rounded to the activation dtype, as the JAX module casts
        # it; a Python float, so the forward uploads nothing
        self.scale = torch.tensor(1.0 / math.sqrt(cfg.head_dim), dtype=_dt(cfg)).item()

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        h, d = cfg.num_attention_heads, cfg.head_dim
        dt = _dt(cfg)

        def heads(y):  # (B, L, H*d) -> (B, H, L, d)
            return y.reshape(*y.shape[:-1], h, d).transpose(-3, -2)

        if self.cross:
            q = heads(self.query(q_in))
            k, v = (heads(t) for t in self.kv(kv_in).chunk(2, dim=-1))
        else:
            if kv_in is not q_in:
                raise ValueError("self-attention takes the same tensor as q_in and kv_in")
            q, k, v = (heads(t) for t in self.qkv(q_in).chunk(3, dim=-1))

        scores = torch.matmul(q * self.scale, k.transpose(-1, -2))  # (B, H, Q, K)
        if bias is not None:
            scores = scores + bias.to(dt)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        probs = self.dropout(probs)
        ctx = torch.matmul(probs, v).to(dt)  # (B, H, Q, d)
        ctx = ctx.transpose(-3, -2)
        return ctx.reshape(*ctx.shape[:-2], h * d)


class AttentionBlock(nn.Module):
    """Attention + output projection + residual LayerNorm."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.att = Attention(cfg, cross, device)
        self.out_dense = Dense(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg, device=device)

    def forward(self, q_in, kv_in, bias=None):
        out = self.dropout(self.out_dense(self.att(q_in, kv_in, bias)))
        return self.out_ln(out + q_in).to(self.dtype)


class Ffn(nn.Module):
    """Intermediate + output FFN with residual LayerNorm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.inter = Dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.out_dense = Dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.out_ln = LayerNorm(cfg, device=device)

    def forward(self, x):
        y = self.out_dense(F.gelu(self.inter(x), approximate="none"))
        return self.out_ln(self.dropout(y) + x).to(self.dtype)


class BertLayer(nn.Module):
    """Post-norm self-attention transformer layer."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attn = AttentionBlock(cfg, cross=False, device=device)
        self.ffn = Ffn(cfg, device)

    def forward(self, x, bias=None):
        return self.ffn(self.attn(x, x, bias))


class BertXLayer(nn.Module):
    """Cross-modal layer.

    ``forward``   : the visual stream cross-attends to language, then
                    self-attends (with the distance bias added to its mask
                    bias when given), then the FFN;
    ``lang2visn`` : the language stream cross-attends to the visual stream
                    through the same ``cross`` block, then ``lang_self_attn``
                    and ``lang_ffn`` (the MLM forward);
    ``visn2visn`` : self-attention and FFN only (SEM's 'sattn' mode).

    ``lang_self_attn``/``lang_ffn`` exist only with ``lang2visn=True``: flax
    creates them only in trees whose init ran the MLM forward, and the
    converter loads strictly."""

    def __init__(self, cfg: ModelConfig, device=None, lang2visn: bool = False):
        super().__init__()
        self.cross = AttentionBlock(cfg, cross=True, device=device)
        self.self_attn = AttentionBlock(cfg, cross=False, device=device)
        self.ffn = Ffn(cfg, device)
        if lang2visn:
            self.lang_self_attn = AttentionBlock(cfg, cross=False, device=device)
            self.lang_ffn = Ffn(cfg, device)

    def forward(self, visn, lang, lang_bias, visn_bias, sprel_bias=None):
        x = self.cross(visn, lang, lang_bias)
        bias = visn_bias if sprel_bias is None else visn_bias + sprel_bias
        x = self.self_attn(x, x, bias)
        return self.ffn(x)

    def lang2visn(self, lang, visn, visn_bias, lang_bias):
        x = self.cross(lang, visn, visn_bias)
        x = self.lang_self_attn(x, x, lang_bias)
        return self.lang_ffn(x)

    def visn2visn(self, visn, visn_bias):
        return self.ffn(self.self_attn(visn, visn, visn_bias))


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.word_embeddings = Embed(cfg, cfg.vocab_size, device)
        self.position_embeddings = Embed(cfg, cfg.max_position_embeddings, device)
        self.token_type_embeddings = Embed(cfg, cfg.type_vocab_size, device)
        self.ln = LayerNorm(cfg, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.ln(x).to(self.dtype))


class PanoEncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer of the panorama encoder."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.ln1 = LayerNorm(cfg, device=device)
        self.att = Attention(cfg, cross=False, device=device)
        self.att_out = Dense(cfg, hid, hid, device)
        self.ln2 = LayerNorm(cfg, device=device)
        self.inter = Dense(cfg, hid, cfg.intermediate_size, device)
        self.out_dense = Dense(cfg, cfg.intermediate_size, hid, device)
        self.drop_att = Dropout(cfg.hidden_dropout_prob)
        self.drop_inter = Dropout(cfg.hidden_dropout_prob)
        self.drop_out = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, bias=None):
        y = self.ln1(x).to(self.dtype)
        y = self.drop_att(self.att_out(self.att(y, y, bias)))
        x = x + y
        y = self.ln2(x).to(self.dtype)
        y = self.drop_inter(F.gelu(self.inter(y), approximate="none"))
        return x + self.drop_out(self.out_dense(y))


class MlmHead(nn.Module):
    """Masked-LM head: dense transform, exact GELU, float32 LayerNorm, and a
    decoder tied to the (vocab, hidden) word-embedding table, with float32
    logits (the JAX einsum's float32 accumulation of exact bf16 products, as
    a float32 matmul of the same values) plus the head's own ``bias``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        self.transform = Dense(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.transform_ln = LayerNorm(cfg, device=device)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size, dtype=_pdt(cfg), device=device))

    def forward(self, hidden: torch.Tensor, tied_embedding: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.transform(hidden), approximate="none")
        x = self.transform_ln(x).to(self.dtype)
        logits = torch.matmul(x.float(), tied_embedding.to(self.dtype).float().T)
        return logits + self.bias.float()


class TwoLayerHead(nn.Module):
    """Linear-ReLU-LN-Linear prediction head; float32 output."""

    def __init__(self, cfg: ModelConfig, out_dim: int = 1,
                 in_features: Optional[int] = None, device=None):
        super().__init__()
        self.dtype = _dt(cfg)
        hid = cfg.hidden_size
        self.fc1 = Dense(cfg, in_features or hid, hid, device)
        self.ln = LayerNorm(cfg, device=device)
        self.fc2 = Dense(cfg, hid, out_dim, device)

    def forward(self, x):
        y = self.ln(F.relu(self.fc1(x))).to(self.dtype)
        return self.fc2(y).float()
