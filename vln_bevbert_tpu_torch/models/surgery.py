"""Checkpoint surgery: parameter transfer between training stages and the
reference checkpoints' remaps (port of ``vln_bevbert_tpu/models/surgery.py``).

The navigation model contains the pretraining backbone as the same ``bert``
submodule and the same SAP heads (``global_sap_head``, ``local_sap_head``,
``sap_fuse_linear``), so a stage transfer copies every entry whose name the
destination also has. The JAX functions walk nested flax trees; here both
sides of ``transfer_pretrained`` are flat ``state_dict``s.

The remaps are the JAX module's numpy functions, copied: ``hf_bert_to_tree``
(a HuggingFace BERT / XLM-R state dict), ``lxmert_surgery`` and
``roberta_surgery`` (key surgery into the reference namespace) and
``reference_ckpt_to_tree`` (that namespace, or a BEVBert pretraining
output, to the model's tree), and ``load_hf_bert``. Each returns a
flax-path tree, which ``convert.flax_to_state_dict`` maps onto the port's
names (Dense kernels transposed) before ``transfer_pretrained`` merges it
(``hf_state_dict`` for ``hf_bert_to_tree``'s ``bert`` subtree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..convert import flax_to_state_dict


def _fits(src: Mapping[str, torch.Tensor], name: str, value: torch.Tensor) -> bool:
    return name in src and tuple(src[name].shape) == tuple(value.shape)


def transfer_pretrained(src: Mapping[str, torch.Tensor],
                        dst: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A new state dict shaped like ``dst``: each entry of ``src`` whose name
    is in ``dst`` with the same shape, and ``dst``'s own (fresh) value for
    every other name."""
    return {k: src[k] if _fits(src, k, v) else v for k, v in dst.items()}


def count_transferred(src: Mapping[str, torch.Tensor], dst: Mapping[str, torch.Tensor]) -> int:
    """How many entries of ``dst`` ``transfer_pretrained`` takes from ``src``."""
    return sum(_fits(src, k, v) for k, v in dst.items())


def hf_state_dict(hf_tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``hf_bert_to_tree``'s (or ``load_hf_bert``'s) tree, which holds the
    ``bert`` submodule's embeddings and language layers, by the port's
    ``state_dict`` names (``bert.embeddings...``, ``bert.lang_encoder...``)."""
    return flax_to_state_dict({"bert": hf_tree})


def _set(tree: Dict[str, Any], path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def hf_bert_to_tree(state_dict: Dict[str, "np.ndarray"], num_l_layers: int = 9,
                    hidden: int = 768) -> Dict[str, Any]:
    """Map a HuggingFace bert-base torch state dict (numpy-converted) onto our
    param-tree layout (models/bert.py / encoders.py naming). Returns a partial
    tree to merge with ``transfer_pretrained``.

    HF layout: bert.embeddings.{word,position,token_type}_embeddings.weight,
    bert.encoder.layer.N.attention.self.{query,key,value}.{weight,bias},
    .attention.output.dense/LayerNorm, .intermediate.dense, .output.dense/LayerNorm.
    XLM-RoBERTa checkpoints share the encoder layout under a 'roberta.'
    prefix (the reference's RxR path, pretrain_src/train_r2r.py:131-148).
    """
    sd = {}
    roberta_style = False
    for k, v in state_dict.items():
        for prefix in ("roberta.", "xlm_roberta."):
            if k.startswith(prefix):
                roberta_style = True
        for prefix in ("bert.", "roberta.", "xlm_roberta."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        sd[k] = np.asarray(v)
    tree: Dict[str, Any] = {}

    def lin(prefix, transpose=True):
        w = sd[f"{prefix}.weight"]
        b = sd[f"{prefix}.bias"]
        return {"kernel": w.T if transpose else w, "bias": b}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    emb = "embeddings"
    _set(tree, (emb, "word_embeddings", "embedding"),
         sd["embeddings.word_embeddings.weight"])
    pos_table = sd["embeddings.position_embeddings.weight"]
    if roberta_style:
        # RoBERTa position ids start at padding_idx + 1 = 2, so the first two
        # table rows are never trained for real positions. The reference maps
        # them naively (pretrain_src/train_r2r.py:131-148); we drop the +2 pad
        # offset so row i is the embedding of position i.
        pos_table = pos_table[2:]
    _set(tree, (emb, "position_embeddings", "embedding"), pos_table)
    tt_table = sd["embeddings.token_type_embeddings.weight"]
    if roberta_style and tt_table.shape[0] == 1:
        # the reference duplicates RoBERTa's single token-type row so row 1
        # serves the image token type (train_r2r.py:127-130), matching the
        # type_vocab_size=2 config patch (vlnbert_init.py:54-55)
        tt_table = np.concatenate([tt_table] * 2, axis=0)
    _set(tree, (emb, "token_type_embeddings", "embedding"), tt_table)
    _set(tree, (emb, "ln"), ln("embeddings.LayerNorm"))

    for i in range(num_l_layers):
        hf = f"encoder.layer.{i}"
        base = ("lang_encoder", f"layer_{i}")
        # our self-attention uses a fused QKV projection: concat the three
        # HF matrices (concat-of-matmuls == matmul-of-concat)
        q = lin(f"{hf}.attention.self.query")
        k = lin(f"{hf}.attention.self.key")
        v = lin(f"{hf}.attention.self.value")
        _set(tree, base + ("attn", "att", "qkv"), {
            "kernel": np.concatenate([q["kernel"], k["kernel"], v["kernel"]], axis=1),
            "bias": np.concatenate([q["bias"], k["bias"], v["bias"]]),
        })
        _set(tree, base + ("attn", "out_dense"), lin(f"{hf}.attention.output.dense"))
        _set(tree, base + ("attn", "out_ln"), ln(f"{hf}.attention.output.LayerNorm"))
        _set(tree, base + ("ffn", "inter"), lin(f"{hf}.intermediate.dense"))
        _set(tree, base + ("ffn", "out_dense"), lin(f"{hf}.output.dense"))
        _set(tree, base + ("ffn", "out_ln"), ln(f"{hf}.output.LayerNorm"))
    return tree


# ---------------------------------------------------------------------------
# Reference-format checkpoint surgery
#
# The reference's three torch surgery paths:
#   (a) LXMERT raw ckpt -> reference namespace  (train_r2r.py:119-148 /
#       map_nav_src/models/vlnbert_init.py:20-38),
#   (b) XLM-RoBERTa HF ckpt -> reference namespace with the
#       token_type 1->2 duplication (train_r2r.py:121-131) matching the
#       type_vocab_size=2 config patch (vlnbert_init.py:54-55),
#   (c) reference pretrain-output state dict -> nav model
#       (vlnbert_init.py:40-46: strip 'module.', '_head'/'sap_fuse' keys get
#       a 'bert.' base prefix which from_pretrained strips again).
# Here (a)/(b) are key-level surgeries producing the reference namespace,
# and `reference_ckpt_to_tree` converts that namespace (torch naming) into
# our flax param tree — fused QKV/KV projections, Dense kernel transposes,
# Sequential-index head names. The result is a partial tree for
# `transfer_pretrained`.
# ---------------------------------------------------------------------------


def _t_lin(sd, prefix):
    """torch nn.Linear -> flax Dense leaves."""
    return {"kernel": np.asarray(sd[f"{prefix}.weight"]).T,
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _t_ln(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _t_fused(sd, prefixes):
    """Concat several torch Linears into one fused Dense (concat-of-matmuls
    == matmul-of-concat; models/bert.py Attention qkv/kv)."""
    return {
        "kernel": np.concatenate(
            [np.asarray(sd[f"{p}.weight"]).T for p in prefixes], axis=1
        ),
        "bias": np.concatenate(
            [np.asarray(sd[f"{p}.bias"]) for p in prefixes]
        ),
    }


def lxmert_surgery(sd: Dict[str, Any]) -> Dict[str, Any]:
    """LXMERT checkpoint keys -> reference namespace, replicating
    pretrain_src/train_r2r.py:119-148 exactly: strip 'module.',
    'bert.encoder.layer' -> 'bert.lang_encoder.layer',
    'bert.encoder.x_layers' fans out to BOTH
    'bert.{local,global}_encoder.encoder.x_layers' (same tensor),
    'cls.predictions' -> 'mlm_head.predictions'; everything else verbatim
    (LXMERT's r_layers etc. simply find no module and are dropped later)."""
    out = {}
    for name, v in sd.items():
        name = name.replace("module.", "")
        if "bert.encoder.layer" in name:
            out[name.replace("bert.encoder.layer", "bert.lang_encoder.layer")] = v
        elif "bert.encoder.x_layers" in name:
            out[name.replace("bert.encoder.x_layers",
                             "bert.local_encoder.encoder.x_layers")] = v
            out[name.replace("bert.encoder.x_layers",
                             "bert.global_encoder.encoder.x_layers")] = v
        elif "cls.predictions" in name:
            out[name.replace("cls.predictions", "mlm_head.predictions")] = v
        else:
            out[name] = v
    return out


def roberta_surgery(sd: Dict[str, Any]) -> Dict[str, Any]:
    """XLM-RoBERTa HF parameters -> reference namespace, replicating
    train_r2r.py:121-131: prefix 'bert.', 'bert.encoder.layer' ->
    'bert.lang_encoder.layer', and duplicate the single token-type row to 2
    (the second row becomes the image token type; the model config carries
    the matching type_vocab_size=2 patch, vlnbert_init.py:54-55)."""
    out = {}
    for name, v in sd.items():
        name = "bert." + name
        if "bert.encoder.layer" in name:
            name = name.replace("bert.encoder.layer", "bert.lang_encoder.layer")
        out[name] = np.asarray(v)
    tt = "bert.embeddings.token_type_embeddings.weight"
    if tt in out and out[tt].shape[0] == 1:
        out[tt] = np.concatenate([out[tt]] * 2, axis=0)
    return out


def _ref_bert_layer(sd, pfx):
    """Reference BertLayer (attention/intermediate/output, vilmodel.py:
    195-208) -> our BertLayer tree (fused QKV)."""
    return {
        "attn": {
            "att": {"qkv": _t_fused(sd, [f"{pfx}.attention.self.query",
                                         f"{pfx}.attention.self.key",
                                         f"{pfx}.attention.self.value"])},
            "out_dense": _t_lin(sd, f"{pfx}.attention.output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.attention.output.LayerNorm"),
        },
        "ffn": {
            "inter": _t_lin(sd, f"{pfx}.intermediate.dense"),
            "out_dense": _t_lin(sd, f"{pfx}.output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.output.LayerNorm"),
        },
    }


def _ref_x_layer(sd, pfx):
    """Reference GraphLXRTXLayer (LXMERT naming: visual_attention /
    visn_self_att / visn_inter / visn_output (+ lang_* when
    use_lang2visn_attn), vilmodel.py:365-421) -> our BertXLayer tree
    (cross / self_attn / ffn, fused KV and QKV)."""
    tree = {
        "cross": {
            "att": {
                "query": _t_lin(sd, f"{pfx}.visual_attention.att.query"),
                "kv": _t_fused(sd, [f"{pfx}.visual_attention.att.key",
                                    f"{pfx}.visual_attention.att.value"]),
            },
            "out_dense": _t_lin(sd, f"{pfx}.visual_attention.output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.visual_attention.output.LayerNorm"),
        },
        "self_attn": {
            "att": {"qkv": _t_fused(sd, [f"{pfx}.visn_self_att.self.query",
                                         f"{pfx}.visn_self_att.self.key",
                                         f"{pfx}.visn_self_att.self.value"])},
            "out_dense": _t_lin(sd, f"{pfx}.visn_self_att.output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.visn_self_att.output.LayerNorm"),
        },
        "ffn": {
            "inter": _t_lin(sd, f"{pfx}.visn_inter.dense"),
            "out_dense": _t_lin(sd, f"{pfx}.visn_output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.visn_output.LayerNorm"),
        },
    }
    if f"{pfx}.lang_self_att.self.query.weight" in sd:
        tree["lang_self_attn"] = {
            "att": {"qkv": _t_fused(sd, [f"{pfx}.lang_self_att.self.query",
                                         f"{pfx}.lang_self_att.self.key",
                                         f"{pfx}.lang_self_att.self.value"])},
            "out_dense": _t_lin(sd, f"{pfx}.lang_self_att.output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.lang_self_att.output.LayerNorm"),
        }
        tree["lang_ffn"] = {
            "inter": _t_lin(sd, f"{pfx}.lang_inter.dense"),
            "out_dense": _t_lin(sd, f"{pfx}.lang_output.dense"),
            "out_ln": _t_ln(sd, f"{pfx}.lang_output.LayerNorm"),
        }
    return tree


def _ref_pano_layer(sd, pfx):
    """Reference pre-norm TransformerEncoderLayer (model/transformer.py:
    133-150, torch nn.MultiheadAttention with a stacked q|k|v in_proj) ->
    our PanoEncoderLayer tree. in_proj_weight rows [0:H|H:2H|2H:3H] are
    q|k|v; transposed they become the column blocks our fused qkv splits."""
    return {
        "ln1": _t_ln(sd, f"{pfx}.norm1"),
        "att": {"qkv": {
            "kernel": np.asarray(sd[f"{pfx}.self_attn.in_proj_weight"]).T,
            "bias": np.asarray(sd[f"{pfx}.self_attn.in_proj_bias"]),
        }},
        "att_out": _t_lin(sd, f"{pfx}.self_attn.out_proj"),
        "ln2": _t_ln(sd, f"{pfx}.norm2"),
        "inter": _t_lin(sd, f"{pfx}.linear1"),
        "out_dense": _t_lin(sd, f"{pfx}.linear2"),
    }


def _ref_cls_head(sd, pfx):
    """ClsPrediction/RegionClassification/MulClsPrediction Sequential
    (net.0 Linear / net.2 LayerNorm / net.3 Linear, pretrain_cmt.py:34-71)
    -> our TwoLayerHead (fc1/ln/fc2)."""
    return {
        "fc1": _t_lin(sd, f"{pfx}.net.0"),
        "ln": _t_ln(sd, f"{pfx}.net.2"),
        "fc2": _t_lin(sd, f"{pfx}.net.3"),
    }


def reference_ckpt_to_tree(
    state_dict: Dict[str, Any],
    max_position_embeddings: int = 512,
) -> Dict[str, Any]:
    """Convert a reference-namespace torch state dict — a BEVBert pretrain
    output (`bert.*` + root heads, the vlnbert_init.py:40-46 else-branch
    input), or the result of `lxmert_surgery`/`roberta_surgery` — into our
    flax param-tree layout ({'bert': ..., '<head>': ...}). Only key families
    present in the dict are emitted; merge with ``transfer_pretrained`` into
    either the pretrain model (GlocalTextPathCMTPreTraining) or the nav
    model (GlocalTextPathNavCMT) — both share the 'bert' subtree + root-head
    layout. Layer/x-layer/pano-layer counts are discovered from the keys.

    Oversized position tables (XLM-R's 514 rows) are truncated to
    ``max_position_embeddings``, keeping the reference's naive row-i =
    position-i semantics (train_r2r.py:121-131 maps them without offset).
    """
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k:
          np.asarray(v) for k, v in state_dict.items()}
    tree: Dict[str, Any] = {}
    b = "bert"

    # --- embeddings ---
    emb = "bert.embeddings"
    if f"{emb}.word_embeddings.weight" in sd:
        _set(tree, (b, "embeddings", "word_embeddings", "embedding"),
             sd[f"{emb}.word_embeddings.weight"])
    if f"{emb}.position_embeddings.weight" in sd:
        pos = sd[f"{emb}.position_embeddings.weight"]
        _set(tree, (b, "embeddings", "position_embeddings", "embedding"),
             pos[:max_position_embeddings])
    if f"{emb}.token_type_embeddings.weight" in sd:
        _set(tree, (b, "embeddings", "token_type_embeddings", "embedding"),
             sd[f"{emb}.token_type_embeddings.weight"])
    if f"{emb}.LayerNorm.weight" in sd:
        _set(tree, (b, "embeddings", "ln"), _t_ln(sd, f"{emb}.LayerNorm"))

    # --- language encoder ---
    i = 0
    while f"bert.lang_encoder.layer.{i}.attention.self.query.weight" in sd:
        _set(tree, (b, "lang_encoder", f"layer_{i}"),
             _ref_bert_layer(sd, f"bert.lang_encoder.layer.{i}"))
        i += 1

    # --- panorama embeddings/encoder (ImageEmbeddings, vilmodel.py:465-536) ---
    ie = "bert.img_embeddings"
    pairs = [("img_linear", "img_linear", _t_lin),
             ("img_layer_norm", "img_ln", _t_ln),
             ("loc_linear", "loc_linear", _t_lin),
             ("loc_layer_norm", "loc_ln", _t_ln),
             ("obj_linear", "obj_linear", _t_lin),
             ("obj_layer_norm", "obj_ln", _t_ln),
             ("layer_norm", "ln", _t_ln)]
    for ref_name, our_name, conv in pairs:
        if f"{ie}.{ref_name}.weight" in sd:
            _set(tree, (b, "img_embeddings", our_name), conv(sd, f"{ie}.{ref_name}"))
    if f"{ie}.nav_type_embedding.weight" in sd:
        _set(tree, (b, "img_embeddings", "nav_type_embedding", "embedding"),
             sd[f"{ie}.nav_type_embedding.weight"])
    i = 0
    while f"{ie}.pano_encoder.layers.{i}.self_attn.in_proj_weight" in sd:
        _set(tree, (b, "img_embeddings", f"pano_layer_{i}"),
             _ref_pano_layer(sd, f"{ie}.pano_encoder.layers.{i}"))
        i += 1
    if f"{ie}.pano_encoder.norm.weight" in sd:
        _set(tree, (b, "img_embeddings", "pano_ln"),
             _t_ln(sd, f"{ie}.pano_encoder.norm"))

    # --- global map encoder (vilmodel.py:617-700) ---
    ge = "bert.global_encoder"
    if f"{ge}.gmap_pos_embeddings.0.weight" in sd:
        _set(tree, (b, "global_encoder", "pos_linear"),
             _t_lin(sd, f"{ge}.gmap_pos_embeddings.0"))
        _set(tree, (b, "global_encoder", "pos_ln"),
             _t_ln(sd, f"{ge}.gmap_pos_embeddings.1"))
    if f"{ge}.gmap_step_embeddings.weight" in sd:
        _set(tree, (b, "global_encoder", "step_embedding", "embedding"),
             sd[f"{ge}.gmap_step_embeddings.weight"])
    if f"{ge}.sprel_linear.weight" in sd:
        _set(tree, (b, "global_encoder", "sprel_linear"),
             _t_lin(sd, f"{ge}.sprel_linear"))
    i = 0
    while f"{ge}.encoder.x_layers.{i}.visual_attention.att.query.weight" in sd:
        _set(tree, (b, "global_encoder", f"x_layer_{i}"),
             _ref_x_layer(sd, f"{ge}.encoder.x_layers.{i}"))
        i += 1

    # --- local BEV encoder (vilmodel.py:572-615) ---
    le = "bert.local_encoder"
    if f"{le}.bev_fts_embeddings.0.weight" in sd:
        _set(tree, (b, "local_encoder", "fts_linear"),
             _t_lin(sd, f"{le}.bev_fts_embeddings.0"))
        _set(tree, (b, "local_encoder", "fts_ln"),
             _t_ln(sd, f"{le}.bev_fts_embeddings.1"))
    if f"{le}.bev_pos_embeddings.0.weight" in sd:
        _set(tree, (b, "local_encoder", "pos_linear"),
             _t_lin(sd, f"{le}.bev_pos_embeddings.0"))
        _set(tree, (b, "local_encoder", "pos_ln"),
             _t_ln(sd, f"{le}.bev_pos_embeddings.1"))
    if f"{le}.nav_type_embedding.weight" in sd:
        _set(tree, (b, "local_encoder", "nav_type_embedding", "embedding"),
             sd[f"{le}.nav_type_embedding.weight"])
    i = 0
    while f"{le}.encoder.x_layers.{i}.visual_attention.att.query.weight" in sd:
        _set(tree, (b, "local_encoder", f"x_layer_{i}"),
             _ref_x_layer(sd, f"{le}.encoder.x_layers.{i}"))
        i += 1

    # --- heads (root level; pretrain_cmt.py:82-95) ---
    if "mlm_head.predictions.transform.dense.weight" in sd:
        _set(tree, ("mlm_head", "transform"),
             _t_lin(sd, "mlm_head.predictions.transform.dense"))
        _set(tree, ("mlm_head", "transform_ln"),
             _t_ln(sd, "mlm_head.predictions.transform.LayerNorm"))
        if "mlm_head.predictions.bias" in sd:
            _set(tree, ("mlm_head", "bias"),
                 np.asarray(sd["mlm_head.predictions.bias"]))
        # mlm_head.predictions.decoder.weight is tied to word_embeddings
        # (pretrain_cmt.py:111): our MlmHead consumes the embedding table
        # directly, so the decoder copy is intentionally dropped.
    for head in ("global_sap_head", "local_sap_head", "sap_fuse_linear",
                 "og_head", "local_sem_head", "obj_classifier"):
        if f"{head}.net.0.weight" in sd:
            _set(tree, (head,), _ref_cls_head(sd, head))
    return tree


def load_hf_bert(model_name: str = "bert-base-uncased", num_l_layers: int = 9):
    """Read HF weights from transformers' local cache (torch CPU) and
    convert. Never downloads: a model that is not cached raises."""
    try:
        from transformers import BertModel
    except ImportError as err:
        raise ImportError(
            "load_hf_bert (cli.pretrain --init_bert) needs the transformers package "
            f"and {model_name!r} in its local cache") from err

    model = BertModel.from_pretrained(model_name, local_files_only=True)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return hf_bert_to_tree(sd, num_l_layers=num_l_layers)
