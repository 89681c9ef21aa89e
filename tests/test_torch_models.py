"""Parity of the port's model library (vln_bevbert_tpu_torch.models) with the
flax modules: the same params (converted by vln_bevbert_tpu_torch.convert)
and the same numpy inputs go through both.

Tolerances: float32 at atol=rtol=1e-4 (the algorithm); the one bfloat16 case
at atol=3e-2*max|x|, because bf16 rounds at other points in the two
frameworks.
"""

import jax
import numpy as np
import pytest
import torch

from test_models import TINY, make_batch
from vln_bevbert_tpu.models import bert as jbert
from vln_bevbert_tpu.models import encoders as jenc
from vln_bevbert_tpu.models.glocal import GlocalTextPathCMT as JaxGlocal
from vln_bevbert_tpu.models.nav import GlocalTextPathNavCMT as JaxNav
from vln_bevbert_tpu.ops.masking import attn_bias
from vln_bevbert_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
    module_to_flax,
)
from vln_bevbert_tpu_torch.models import bert as tbert
from vln_bevbert_tpu_torch.models import encoders as tenc
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMT
from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT
from vln_bevbert_tpu_torch.utils.rng import make_generator

TOL = dict(atol=1e-4, rtol=1e-4)
B, L, N, D = 2, 6, 5, TINY.hidden_size


def tt(x):
    """numpy / jax array (or a dict of them) -> torch tensor(s)."""
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def jax_init_apply(module, *args):
    params = module.init(jax.random.key(0), *args)["params"]
    return jax.tree.map(np.asarray, params), module.apply({"params": params}, *args)


def port(module, params):
    load_flax_params(module, params)
    return module.eval()


def close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def masks(rng, b, n):
    m = rng.uniform(size=(b, n)) < 0.7
    m[:, 0] = True
    return m


# ------------------------------------------------------------------ convert
def test_convert_round_trip_and_leftovers(rng):
    lang_in = {"txt_ids": np.ones((B, L), np.int32), "txt_masks": np.ones((B, L), bool)}
    params = jax.tree.map(
        np.asarray, JaxNav(TINY).init(jax.random.key(0), "language", lang_in)["params"]
    )
    model = GlocalTextPathNavCMT(TINY)
    # the language init covers only part of the nav model: a strict load refuses
    with pytest.raises(KeyError, match="without a value"):
        load_flax_params(model, params)
    sub = GlocalTextPathCMT(TINY).lang_encoder
    port(sub, params["bert"]["lang_encoder"])
    back = module_to_flax(sub)
    jax.tree.map(np.testing.assert_array_equal, back, params["bert"]["lang_encoder"])
    # fused qkv stays fused, kernels are transposed
    sd = flax_to_state_dict(params["bert"]["lang_encoder"])
    kernel = params["bert"]["lang_encoder"]["layer_0"]["attn"]["att"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["layer_0.attn.att.qkv.weight"].numpy(), kernel.T)
    extra = {**params["bert"]["lang_encoder"], "stray": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(KeyError, match="unused flax params"):
        load_flax_params(sub, extra)
    bad = jax.tree.map(lambda a: a, params["bert"]["lang_encoder"])
    bad["layer_0"]["ffn"]["inter"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="flax shape"):
        load_flax_params(sub, bad)
    with pytest.raises(KeyError, match="unknown flax parameter leaf"):
        flax_to_state_dict({"x": {"mean": np.zeros(2)}})


def test_init_params_follow_flax_initialisers():
    model = GlocalTextPathNavCMT(TINY)
    tbert.init_params(model, make_generator(0))
    w = model.bert.embeddings.word_embeddings.weight
    assert abs(w.std().item() - TINY.initializer_range) < 1e-3
    assert torch.all(model.bert.embeddings.ln.weight == 1)
    assert torch.all(model.global_sap_head.fc1.bias == 0)
    again = GlocalTextPathNavCMT(TINY)
    tbert.init_params(again, make_generator(0))
    torch.testing.assert_close(again.state_dict(), model.state_dict())


# ---------------------------------------------------------------- bert.py
@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_flax(rng, cross):
    q = rng.normal(size=(B, L, D)).astype(np.float32)
    kv = rng.normal(size=(B, N, D)).astype(np.float32) if cross else q
    keys = kv.shape[1]
    bias = np.asarray(attn_bias(masks(rng, B, keys))) + rng.normal(
        size=(B, 1, L, keys)).astype(np.float32)
    params, ref = jax_init_apply(jbert.Attention(TINY), q, kv, bias)
    ours = port(tbert.Attention(TINY, cross=cross), params)
    tq = tt(q)
    close(ours(tq, tt(kv) if cross else tq, tt(bias)), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_layer_matches_flax(rng, dtype):
    cfg = type(TINY)(**{**TINY.__dict__, "dtype": dtype})
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    bias = np.asarray(attn_bias(masks(rng, B, L)))
    params, ref = jax_init_apply(jbert.BertLayer(cfg), x, bias)
    ours = port(tbert.BertLayer(cfg), params)(tt(x).to(getattr(torch, dtype)), tt(bias))
    if dtype == "float32":
        close(ours, ref)
    else:
        assert ours.dtype == torch.bfloat16
        ref = np.asarray(ref, np.float32)
        close(ours, ref, atol=3e-2 * np.abs(ref).max(), rtol=0)


def test_bert_xlayer_with_sprel_matches_flax(rng):
    visn = rng.normal(size=(B, N, D)).astype(np.float32)
    lang = rng.normal(size=(B, L, D)).astype(np.float32)
    lang_bias = np.asarray(attn_bias(masks(rng, B, L)))
    visn_bias = np.asarray(attn_bias(masks(rng, B, N)))
    sprel = rng.normal(size=(B, 1, N, N)).astype(np.float32)
    params, ref = jax_init_apply(jbert.BertXLayer(TINY), visn, lang, lang_bias,
                                 visn_bias, sprel)
    ours = port(tbert.BertXLayer(TINY), params)
    close(ours(tt(visn), tt(lang), tt(lang_bias), tt(visn_bias), tt(sprel)), ref)


def test_pano_layer_and_two_layer_head_match_flax(rng):
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    bias = np.asarray(attn_bias(masks(rng, B, N)))
    params, ref = jax_init_apply(jbert.PanoEncoderLayer(TINY), x, bias)
    close(port(tbert.PanoEncoderLayer(TINY), params)(tt(x), tt(bias)), ref)
    x2 = rng.normal(size=(B, N, 2 * D)).astype(np.float32)
    params, ref = jax_init_apply(jbert.TwoLayerHead(TINY, 3), x2)
    close(port(tbert.TwoLayerHead(TINY, 3, in_features=2 * D), params)(tt(x2)), ref)


# ------------------------------------------------------------ encoders.py
def test_image_embeddings_match_flax(rng):
    V, A = 7, TINY.angle_feat_size
    view_fts = rng.normal(size=(B, V, TINY.image_feat_size)).astype(np.float32)
    loc_fts = rng.normal(size=(B, V, A + 3)).astype(np.float32)
    nav_types = rng.integers(0, 2, size=(B, V)).astype(np.int32)
    view_lens = np.array([V, 3], np.int32)
    tok = rng.normal(size=(D,)).astype(np.float32)
    module = jenc.ImageEmbeddings(TINY)
    params = module.init(jax.random.key(0), view_fts, loc_fts, nav_types, view_lens,
                         token_type_vis=tok)["params"]
    ref_x, ref_m = module.apply({"params": params}, view_fts, loc_fts, nav_types,
                                view_lens, token_type_vis=tok)
    ours = port(tenc.ImageEmbeddings(TINY), jax.tree.map(np.asarray, params))
    x, m = ours(tt(view_fts), tt(loc_fts), tt(nav_types), tt(view_lens), tt(tok))
    close(x, ref_x)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))


def _map_inputs(rng):
    A = TINY.angle_feat_size
    txt = rng.normal(size=(B, L, D)).astype(np.float32)
    return txt, masks(rng, B, L), A


def test_global_map_encoder_matches_flax(rng):
    txt, txt_masks, A = _map_inputs(rng)
    img = rng.normal(size=(B, N, D)).astype(np.float32)
    step_ids = rng.integers(0, 10, size=(B, N)).astype(np.int32)
    pos = rng.normal(size=(B, N, A + 3)).astype(np.float32)
    gmask = masks(rng, B, N)
    dists = rng.uniform(0, 1, size=(B, N, N)).astype(np.float32)
    args = (txt, txt_masks, img, step_ids, pos, gmask, dists)
    params, ref = jax_init_apply(jenc.GlobalMapEncoder(TINY), *args)
    close(port(tenc.GlobalMapEncoder(TINY), params)(*map(tt, args)), ref)


def test_local_bev_encoder_matches_flax(rng):
    txt, txt_masks, A = _map_inputs(rng)
    C = TINY.num_bev_tokens
    bev = rng.normal(size=(B, C, TINY.bev_grid_feat_size)).astype(np.float32)
    pos = rng.normal(size=(B, C, A + 6)).astype(np.float32)
    bmask = masks(rng, B, C)
    nav = rng.uniform(size=(B, C)) < 0.2
    args = (txt, txt_masks, bev, pos, bmask, nav)
    params, (ref, _) = jax_init_apply(jenc.LocalBEVEncoder(TINY), *args)
    bev_out, obj_out = port(tenc.LocalBEVEncoder(TINY), params)(*map(tt, args))
    close(bev_out, ref)
    assert obj_out is None


# -------------------------------------------------------- glocal / nav
def test_glocal_backbone_matches_flax():
    batch = make_batch(with_objects=False)
    assert "traj_obj_fts" not in batch
    module = JaxGlocal(TINY)
    params = module.init(jax.random.key(0), batch)["params"]
    gmap_ref, bev_ref, _, _ = module.apply({"params": params}, batch)
    ours = port(GlocalTextPathCMT(TINY), jax.tree.map(np.asarray, params))
    gmap, bev, obj, obj_masks = ours({k: tt(v) for k, v in batch.items()})
    close(gmap, gmap_ref)
    close(bev, bev_ref)
    assert obj is None and obj_masks is None


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out and isinstance(v, dict) else out.get(k, v)
    return out


@pytest.mark.parametrize("variant", [{}, {"glocal_fuse": False}, {"use_bev": False},
                                     {"graph_sprels": False}])
def test_nav_model_modes_match_flax(variant):
    cfg = type(TINY)(**{**TINY.__dict__, **variant})
    batch = make_batch(with_objects=False)
    rng = np.random.default_rng(3)
    n = batch["gmap_masks"].shape[1]
    lang_in = {"txt_ids": batch["txt_ids"], "txt_masks": batch["txt_masks"]}
    pano_in = {k: batch[f"traj_{k}"][:, 0]
               for k in ("view_fts", "loc_fts", "nav_types", "view_lens")}
    nav_in = {k: batch[k] for k in (
        "txt_masks", "gmap_step_ids", "gmap_pos_fts", "gmap_masks", "gmap_pair_dists",
        "gmap_visited_masks", "bev_fts", "bev_pos_fts", "bev_masks", "bev_nav_masks",
        "bev_cand_idxs", "local_masks", "fuse_map")}
    nav_in["gmap_img_embeds"] = rng.normal(size=(B, n, D)).astype(np.float32)
    nav_in["txt_embeds"] = rng.normal(size=batch["txt_ids"].shape + (D,)).astype(np.float32)

    model = JaxNav(cfg)
    params = {}
    for mode, inp in (("navigation", nav_in), ("language", lang_in), ("panorama", pano_in)):
        params = _merge(params, model.init(jax.random.key(1), mode, inp)["params"])
    ours = port(GlocalTextPathNavCMT(cfg), jax.tree.map(np.asarray, params))
    apply = lambda mode, inp: model.apply({"params": params}, mode, inp)

    close(ours("language", tt(lang_in)), apply("language", lang_in))
    (x, m), (rx, rm) = ours("panorama", tt(pano_in)), apply("panorama", pano_in)
    close(x, rx)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(rm))
    out, ref = ours("navigation", tt(nav_in)), apply("navigation", nav_in)
    for key in ("global_logits", "local_logits", "fused_logits", "gmap_embeds",
                "bev_embeds"):
        if ref[key] is None:
            assert out[key] is None
        else:
            close(out[key], ref[key])
    fl = out["fused_logits"].detach().numpy()
    assert (fl[~batch["gmap_masks"]] <= -9999).all()
