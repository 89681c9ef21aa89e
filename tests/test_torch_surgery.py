"""The port's checkpoint surgery (``models/surgery.py``) against the port's
``state_dict``, mirroring ``tests/test_surgery.py``: a HuggingFace BERT
(randomly initialised from a bare config, no downloads) remapped onto the
port's language stack gives HF's hidden states; the reference-format
checkpoints (LXMERT, XLM-R, a BEVBert pretraining output, with the
reference's exact key names and shapes from ``test_surgery.py``'s
``synthetic_reference_sd``) reach every entry of the port's pretraining
model, and each remapped tree equals the JAX package's after
``convert.flax_to_state_dict``.

Tolerance: the HF forward within 1e-5 abs (float32, the same algorithm);
everything else is equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_surgery import _small_cfg, synthetic_reference_sd
from vln_bevbert_tpu.models import surgery as jax_surgery
from vln_bevbert_tpu_torch.configs import ModelConfig
from vln_bevbert_tpu_torch.convert import flax_to_state_dict
from vln_bevbert_tpu_torch.models import surgery
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT

transformers = pytest.importorskip("transformers")


def reference_state_dict(sd, max_position_embeddings=512):
    return flax_to_state_dict(surgery.reference_ckpt_to_tree(sd, max_position_embeddings))


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for name, val in want.items():
        assert torch.equal(got[name], val), name


def test_hf_bert_forward_parity():
    hf_cfg = transformers.BertConfig(
        vocab_size=500, hidden_size=48, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=96, max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    cfg = ModelConfig(vocab_size=500, hidden_size=48, num_attention_heads=4,
                      intermediate_size=96, num_l_layers=3, num_pano_layers=1, num_x_layers=1,
                      image_feat_size=8, bev_grid_feat_size=8, bev_dim=3,
                      max_position_embeddings=64, dtype="float32", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    model = GlocalTextPathCMTPreTraining(cfg, ("mlm", "sap")).eval()
    sd = {f"bert.{k}": v.detach().numpy() for k, v in hf.state_dict().items()}
    tree = surgery.hf_bert_to_tree(sd, num_l_layers=3)
    src = surgery.hf_state_dict(tree)
    assert_same_state(src, flax_to_state_dict({"bert": jax_surgery.hf_bert_to_tree(sd, 3)}))
    own = model.state_dict()
    assert surgery.count_transferred(src, own) == len(src) == 5 + 3 * 12
    model.load_state_dict(surgery.transfer_pretrained(src, own))

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 500, (2, 12))
    masks = np.arange(12)[None, :] < np.array([12, 7])[:, None]
    with torch.no_grad():
        ours = model.bert.encode_text(torch.from_numpy(ids).int(), torch.from_numpy(masks))
        theirs = hf(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(masks.astype(np.int64))).last_hidden_state
    np.testing.assert_allclose(ours.numpy()[masks], theirs.numpy()[masks], atol=1e-5, rtol=0)


def test_transfer_keeps_fresh_on_mismatch():
    dst = {"a.w": torch.zeros(2, 2), "b": torch.ones(3)}
    src = {"a.w": torch.full((4, 4), 7.0), "c": torch.zeros(1)}
    out = surgery.transfer_pretrained(src, dst)
    assert torch.equal(out["a.w"], torch.zeros(2, 2))  # shape mismatch
    assert torch.equal(out["b"], torch.ones(3))        # missing from src
    assert surgery.count_transferred(src, dst) == 0 and sorted(out) == ["a.w", "b"]


def test_pretrain_to_nav_transfer_is_identity_on_bert():
    cfg = ModelConfig(vocab_size=300, hidden_size=16, num_attention_heads=2,
                      intermediate_size=32, num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                      image_feat_size=8, bev_grid_feat_size=8, bev_dim=3, dtype="float32",
                      max_position_embeddings=32)
    torch.manual_seed(0)
    pre = GlocalTextPathCMTPreTraining(cfg, ("sap",)).eval()
    with torch.no_grad():
        for p in pre.parameters():
            p.normal_(0, 0.5)
    nav = GlocalTextPathNavCMT(cfg).eval()
    merged = surgery.transfer_pretrained(pre.state_dict(), nav.state_dict())
    nav.load_state_dict(merged)
    for name, val in nav.state_dict().items():
        if name.startswith("bert.embeddings."):
            assert torch.equal(val, pre.state_dict()[name]), name
    ids = torch.randint(1, 300, (2, 12), generator=torch.Generator().manual_seed(1))
    masks = torch.arange(12)[None, :] < torch.tensor([12, 5])[:, None]
    with torch.no_grad():
        torch.testing.assert_close(nav.forward_text(ids, masks), pre.bert.encode_text(ids, masks),
                                   atol=1e-6, rtol=0)


def pretrain_state(cfg) -> dict:
    model = GlocalTextPathCMTPreTraining(cfg, ("mlm", "sap", "masksem"))
    return model.state_dict()


def small_cfg() -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(_small_cfg()))


def test_reference_ckpt_full_coverage_and_numerics():
    """Every entry of the port's pretraining model comes from a
    reference-format pretraining output (only the tied mlm decoder copy is
    dropped); Dense kernels land back in torch's (out, in) layout, the fused
    KV / QKV projections in the port's ``Attention`` column blocks."""
    cfg = small_cfg()
    own = pretrain_state(cfg)
    sd = synthetic_reference_sd(_small_cfg(), np.random.default_rng(1))
    src = reference_state_dict(sd, max_position_embeddings=cfg.max_position_embeddings)
    assert_same_state(src, flax_to_state_dict(jax_surgery.reference_ckpt_to_tree(
        sd, max_position_embeddings=cfg.max_position_embeddings)))
    assert surgery.count_transferred(src, own) == len(own)
    merged = surgery.transfer_pretrained(src, own)
    np.testing.assert_array_equal(merged["bert.local_encoder.fts_linear.weight"].numpy(),
                                  sd["bert.local_encoder.bev_fts_embeddings.0.weight"])
    h = cfg.hidden_size
    kv = merged["bert.global_encoder.x_layer_0.cross.att.kv.weight"].numpy()
    ref = "bert.global_encoder.encoder.x_layers.0.visual_attention.att"
    np.testing.assert_array_equal(kv[:h], sd[f"{ref}.key.weight"])
    np.testing.assert_array_equal(kv[h:], sd[f"{ref}.value.weight"])
    np.testing.assert_array_equal(
        merged["bert.img_embeddings.pano_layer_0.att.qkv.weight"].numpy(),
        sd["bert.img_embeddings.pano_encoder.layers.0.self_attn.in_proj_weight"])
    np.testing.assert_array_equal(merged["mlm_head.bias"].numpy(), sd["mlm_head.predictions.bias"])


def test_lxmert_surgery_namespace():
    v = np.zeros((4, 4), np.float32)
    sd = {
        "module.bert.encoder.layer.0.attention.self.query.weight": v,
        "module.bert.encoder.x_layers.1.visn_inter.dense.weight": v,
        "module.cls.predictions.bias": np.zeros(7, np.float32),
        "module.bert.embeddings.word_embeddings.weight": v,
        "module.bert.encoder.r_layers.0.attention.self.query.weight": v,
    }
    out = surgery.lxmert_surgery(sd)
    assert sorted(out) == sorted(jax_surgery.lxmert_surgery(sd))
    assert {"bert.lang_encoder.layer.0.attention.self.query.weight",
            "bert.local_encoder.encoder.x_layers.1.visn_inter.dense.weight",
            "bert.global_encoder.encoder.x_layers.1.visn_inter.dense.weight",
            "mlm_head.predictions.bias", "bert.embeddings.word_embeddings.weight",
            "bert.encoder.r_layers.0.attention.self.query.weight"} == set(out)


def test_lxmert_path_loads_lang_and_both_xlayer_branches():
    cfg = small_cfg()
    own = pretrain_state(cfg)
    ref = synthetic_reference_sd(_small_cfg(), np.random.default_rng(2))
    lx = {}
    for k, v in ref.items():
        if k.startswith("bert.lang_encoder.layer."):
            lx["module." + k.replace("bert.lang_encoder.layer.", "bert.encoder.layer.")] = v
        elif k.startswith("bert.global_encoder.encoder.x_layers."):
            lx["module." + k.replace("bert.global_encoder.encoder.x_layers.",
                                     "bert.encoder.x_layers.")] = v
        elif k.startswith("mlm_head.predictions."):
            lx["module." + k.replace("mlm_head.predictions.", "cls.predictions.")] = v
        elif k.startswith("bert.embeddings."):
            lx["module." + k] = v
    src = reference_state_dict(surgery.lxmert_surgery(lx), cfg.max_position_embeddings)
    assert_same_state(src, flax_to_state_dict(jax_surgery.reference_ckpt_to_tree(
        jax_surgery.lxmert_surgery(lx), cfg.max_position_embeddings)))
    merged = surgery.transfer_pretrained(src, own)
    inter = ref["bert.global_encoder.encoder.x_layers.0.visn_inter.dense.weight"]
    for branch in ("global_encoder", "local_encoder"):
        np.testing.assert_array_equal(
            merged[f"bert.{branch}.x_layer_0.ffn.inter.weight"].numpy(), inter)
    np.testing.assert_array_equal(merged["bert.lang_encoder.layer_1.ffn.inter.weight"].numpy(),
                                  ref["bert.lang_encoder.layer.1.intermediate.dense.weight"])
    np.testing.assert_array_equal(merged["mlm_head.bias"].numpy(), ref["mlm_head.predictions.bias"])


def test_roberta_surgery_token_type_patch():
    rng = np.random.default_rng(3)
    tt = rng.normal(size=(1, 8)).astype(np.float32)
    sd = {
        "embeddings.token_type_embeddings.weight": tt,
        "encoder.layer.0.attention.self.query.weight": rng.normal(size=(8, 8)).astype(np.float32),
        "pooler.dense.weight": rng.normal(size=(8, 8)).astype(np.float32),
    }
    out = surgery.roberta_surgery(sd)
    want = jax_surgery.roberta_surgery(sd)
    assert sorted(out) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    got_tt = out["bert.embeddings.token_type_embeddings.weight"]
    assert got_tt.shape == (2, 8)
    np.testing.assert_array_equal(got_tt[1], tt[0])
    assert "bert.lang_encoder.layer.0.attention.self.query.weight" in out
    src = reference_state_dict({k: v for k, v in out.items() if "token_type" in k})
    assert torch.equal(src["bert.embeddings.token_type_embeddings.weight"],
                       torch.from_numpy(np.concatenate([tt, tt])))


def test_reference_ckpt_truncates_oversized_position_table():
    pos = np.random.default_rng(4).normal(size=(34, 8)).astype(np.float32)
    src = reference_state_dict({"bert.embeddings.position_embeddings.weight": pos},
                                       max_position_embeddings=32)
    got = src["bert.embeddings.position_embeddings.weight"]
    assert tuple(got.shape) == (32, 8)
    np.testing.assert_array_equal(got.numpy(), pos[:32])


def test_roberta_position_offset_and_token_types():
    """XLM-R state dicts drop the +2 pad offset of their position table and
    duplicate their single token-type row; BERT ones keep both as they are."""
    rng = np.random.default_rng(0)
    d = 8
    pos = rng.normal(size=(514, d)).astype(np.float32)
    tt = rng.normal(size=(1, d)).astype(np.float32)

    def make_sd(prefix):
        return {
            f"{prefix}embeddings.word_embeddings.weight": rng.normal(size=(32, d)),
            f"{prefix}embeddings.position_embeddings.weight": pos,
            f"{prefix}embeddings.token_type_embeddings.weight": tt,
            f"{prefix}embeddings.LayerNorm.weight": np.ones(d),
            f"{prefix}embeddings.LayerNorm.bias": np.zeros(d),
        }

    for prefix, rows, types in (("roberta.", pos[2:], np.concatenate([tt, tt])),
                                ("bert.", pos, tt)):
        sd = make_sd(prefix)
        src = surgery.hf_state_dict(surgery.hf_bert_to_tree(sd, num_l_layers=0))
        assert_same_state(src, flax_to_state_dict(
            {"bert": jax_surgery.hf_bert_to_tree(sd, num_l_layers=0)}))
        np.testing.assert_array_equal(src["bert.embeddings.position_embeddings.weight"], rows)
        np.testing.assert_array_equal(src["bert.embeddings.token_type_embeddings.weight"], types)
    assert jax.tree.structure(surgery.hf_bert_to_tree(make_sd("roberta."), 0)) == \
        jax.tree.structure(jax_surgery.hf_bert_to_tree(make_sd("roberta."), 0))
