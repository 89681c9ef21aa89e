"""The port's CLIP vision tower (``vln_bevbert_tpu_torch/models/clip.py``)
against the JAX package's, on the CPU.

- The tower from the JAX init tree (perturbed by N(0, 0.02)) through
  ``convert.load_flax_params`` (the raw ``class_embedding`` and
  ``position_embedding`` leaves and the 4-D patch kernel): ``pooled`` and
  ``grid`` at rtol 1e-4, atol 1e-5, at hidden 32, 2 layers, 2 heads, 32x32
  images (four 16x16 patches).
- ``hf_clip_to_state_dict`` against JAX's ``hf_clip_to_tree`` (through
  ``convert.flax_to_state_dict``) on one synthetic HF-layout state dict:
  equal tensors. The layout is pinned to transformers' own
  ``CLIPVisionModel`` (names and shapes), and the tower with remapped
  weights gives that model's outputs (rtol 1e-4, atol 1e-5).
- ``ce.frozen.load_clip_params`` on its file formats (HF-layout torch file,
  flat ``.npz`` flax tree, the port's own state dict, an HF model directory
  from the local cache) equals the JAX loader's tree; a directory without
  ``config.json`` (orbax) is refused.
- ``precompute.DeviceClipEncoder`` on the CPU gives JAX's ``JaxClipEncoder``
  features from uint8 frames at the same tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import hf_clip_state_dict
from test_torch_finetune import perturbed
from vln_bevbert_tpu.ce import frozen as jax_frozen
from vln_bevbert_tpu.models import clip as jax_clip
from vln_bevbert_tpu.precompute.pipeline import JaxClipEncoder
from vln_bevbert_tpu_torch.ce import frozen
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models import clip
from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

TOWER = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, patch_size=16)
RTOL, ATOL = 1e-4, 1e-5


def jax_tower_params(image=32, seed=0, **kw):
    tower = jax_clip.ClipVisionTower(**{**TOWER, **kw})
    params = tower.init(jax.random.PRNGKey(seed), np.zeros((1, image, image, 3), np.float32))
    return tower, perturbed(jax.tree.map(np.asarray, params["params"]))


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_tower_matches_jax():
    tower, params = jax_tower_params()
    images = np.random.default_rng(3).normal(size=(3, 32, 32, 3)).astype(np.float32)
    ref = tower.apply({"params": params}, images)
    ours = clip.ClipVisionTower(**TOWER, image_size=32)
    load_flax_params(ours, params)
    with torch.no_grad():
        got = ours(torch.from_numpy(images))
    assert got["pooled"].shape == (3, 32) and got["grid"].shape == (3, 4, 32)
    for key in ("pooled", "grid"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    # the tree comes back out unchanged, raw leaves and patch kernel included
    back = module_to_flax(ours)
    for key in ("class_embedding", "position_embedding"):
        np.testing.assert_array_equal(back[key], params[key])
    np.testing.assert_array_equal(back["patch_embedding"]["kernel"],
                                  params["patch_embedding"]["kernel"])
    # widths read off the state dict; heads by OpenAI's rule, width // 64
    assert clip.tower_config(ours.state_dict()) == {**TOWER, "num_heads": 1, "image_size": 32}


def test_hf_remap_matches_jax_and_transformers(tmp_path, monkeypatch):
    # transformers would import its TensorFlow and flax halves too (~15 s)
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    hf_sd = hf_clip_state_dict(hidden=64, inter=96, layers=2, patch=16, image=32, seed=4)
    want = flax_to_state_dict(jax_clip.hf_clip_to_tree(
        {k: v.numpy() for k, v in hf_sd.items()}, num_layers=2))
    got = clip.hf_clip_to_state_dict(hf_sd)
    assert_state_dicts_equal(got, want)

    config = transformers.CLIPVisionConfig(hidden_size=64, intermediate_size=96,
                                           num_hidden_layers=2, num_attention_heads=1,
                                           image_size=32, patch_size=16)
    hf = transformers.CLIPVisionModel(config).eval()
    own = {k: v for k, v in hf.state_dict().items() if not k.endswith("position_ids")}
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in hf_sd.items()}
    hf.load_state_dict(hf_sd, strict=False)
    tower = clip.ClipVisionTower(**clip.tower_config(got))
    tower.load_state_dict(got)
    frames = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    x = torch.from_numpy(clip.preprocess(frames))
    with torch.no_grad():
        ours = tower(x)
        ref = hf(pixel_values=x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours["grid"].numpy(), ref.last_hidden_state[:, 1:].numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours["pooled"].numpy(), ref.pooler_output.numpy(), rtol=RTOL,
                               atol=ATOL)

    # an HF model directory, read from the local cache only
    hf.save_pretrained(tmp_path / "hf_clip")
    assert_state_dicts_equal(frozen.load_clip_params(str(tmp_path / "hf_clip")), got)


def test_load_clip_params_reads_every_file_format_as_jax_does(tmp_path):
    # JAX's loader remaps 12 layers: a narrow 12-layer tower, one patch
    hf_sd = hf_clip_state_dict(hidden=64, inter=64, layers=12, patch=16, image=16, seed=6)
    hf_file = tmp_path / "clip_hf.pt"
    torch.save(hf_sd, hf_file)
    tree = jax_frozen.load_clip_params(str(hf_file))
    want = flax_to_state_dict(tree)
    npz = tmp_path / "clip_tree.npz"
    np.savez(npz, **{"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
    own = tmp_path / "clip_port.pt"
    torch.save(want, own)
    for path in (hf_file, npz, own):
        assert_state_dicts_equal(frozen.load_clip_params(str(path)), want)
    assert_state_dicts_equal(flax_to_state_dict(jax_frozen.load_clip_params(str(npz))), want)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="directory"):
        frozen.load_clip_params(str(tmp_path / "orbax"))


def test_device_clip_encoder_matches_jax_clip_encoder():
    _, params = jax_tower_params(image=32, seed=2, num_heads=1)
    frames = np.random.default_rng(7).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    ref = JaxClipEncoder(params, grid_hw=2, **{**TOWER, "num_heads": 1})
    ours = DeviceClipEncoder(flax_to_state_dict(params), grid_hw=2, device="cpu")
    assert ours.feat_size == 32 and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.encode_views(frames), ref.encode_views(frames), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.encode_grids(frames), ref.encode_grids(frames), rtol=RTOL,
                               atol=ATOL)
