"""The port's small leftovers against the JAX package's, on the CPU.

- ``models.nav.Critic``: the JAX init tree (perturbed by N(0, 0.02)) carried
  by ``convert.load_flax_params`` and back by ``module_to_flax``; the
  deterministic forward at rtol 1e-5, atol 1e-6 (float32); in training
  mode both dropouts through the port's ``Dropout`` (the seeded kernel's
  plain version here): a kept unit is scaled by 2, about half are dropped.
- ``ops.masking.seq_mask``: equal masks.
- ``utils.visualize``: equal images on ``tests/test_aux.py``'s inputs, and
  ``save_image`` writes the same bytes.
- ``utils.profiling``: ``trace`` writes a Chrome trace on the CPU holding
  a ``span`` (the recorder's own tests: ``tests/test_torch_profiling.py``).
- ``precompute.DeviceClipEncoder.from_hf`` on a narrow 12-layer
  ``CLIPVisionConfig`` saved to a directory (no download): the parameters
  of JAX's ``hf_clip_to_tree`` of the same model, and ``JaxClipEncoder.from_hf``'s
  features on that directory at rtol 1e-4, atol 1e-5.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_finetune import perturbed
from vln_bevbert_tpu import configs as jax_configs
from vln_bevbert_tpu.models.nav import Critic as JaxCritic
from vln_bevbert_tpu.ops.masking import seq_mask as jax_seq_mask
from vln_bevbert_tpu.utils import visualize as jax_visualize
from vln_bevbert_tpu_torch import configs, models, ops
from vln_bevbert_tpu_torch.convert import load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.ops.dropout import set_dropout_generator
from vln_bevbert_tpu_torch.utils import profiling, visualize

TINY = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64, dtype="float32")


@pytest.mark.parametrize("width", [32, 48], ids=["hidden", "other_width"])
def test_critic_matches_jax_and_converts(width):
    state = np.random.default_rng(2).normal(size=(5, width)).astype(np.float32)
    jax_critic = JaxCritic(jax_configs.ModelConfig(**TINY))
    params = perturbed(jax_critic.init(jax.random.PRNGKey(0), state)["params"])
    ref = np.asarray(jax_critic.apply({"params": params}, state))

    ours = models.Critic(configs.ModelConfig(**TINY), in_features=width)
    load_flax_params(ours, params)
    back = module_to_flax(ours)
    for name in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], params[name][leaf])
    ours.eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(state)).numpy()
    assert got.shape == ref.shape == (5,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    # training mode: both sites drop through the port's seeded Dropout
    ours.train()
    set_dropout_generator(ours, torch.Generator().manual_seed(3))
    seen = {}
    ours.drop_state.register_forward_hook(lambda m, i, o: seen.__setitem__("state", (i[0], o)))
    ours.drop_hidden.register_forward_hook(lambda m, i, o: seen.__setitem__("hidden", (i[0], o)))
    x = torch.from_numpy(np.repeat(state, 40, axis=0)).requires_grad_()
    ours(x).sum().backward()
    for site, (inp, out) in seen.items():
        kept = out != 0
        torch.testing.assert_close(out[kept], 2 * inp[kept], msg=site)
        # of the nonzero inputs (the hidden site follows a ReLU) half are kept
        assert 0.4 < kept[inp != 0].float().mean() < 0.6, site
    assert x.grad is not None and ours.fc1.weight.grad is not None


def test_seq_mask_matches_jax():
    lens = np.array([0, 3, 7, 2], np.int32)
    got = ops.seq_mask(torch.from_numpy(lens), 7)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_seq_mask(lens, 7)))


def test_visualize_copy_matches_jax(tmp_path):
    occ = np.zeros(25, bool)
    occ[[3, 7, 12]] = True
    walked = [[0, 0, 0], [1, 0, 1], [2, 0, 3]]
    gt = [[0, 0, 0], [2, 0, 2]]
    images = {}
    for pkg, mod in (("jax", jax_visualize), ("port", visualize)):
        bev = mod.render_bev_mask(occ, cand_cells=[12], scale=4)
        bev_2d = mod.render_bev_mask(occ.reshape(5, 5))
        traj = mod.render_topdown_traj(walked, gt)
        mod.save_image(str(tmp_path / f"{pkg}.png"), traj)
        images[pkg] = (bev, bev_2d, traj, (tmp_path / f"{pkg}.png").read_bytes())
    for a, b in zip(images["jax"], images["port"]):
        np.testing.assert_array_equal(np.frombuffer(a, np.uint8) if isinstance(a, bytes) else a,
                                      np.frombuffer(b, np.uint8) if isinstance(b, bytes) else b)
    assert images["port"][0].shape == (20, 20, 3) and images["port"][2].sum() > 0


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("ce_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ce_step" for e in events)
    assert any(e.key == "ce_step" for e in prof.key_averages())


def test_device_clip_encoder_from_hf_matches_jax(tmp_path, monkeypatch):
    # transformers would import its TensorFlow and flax halves too (~15 s)
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    transformers = pytest.importorskip("transformers")
    from vln_bevbert_tpu.models.clip import hf_clip_to_tree
    from vln_bevbert_tpu.precompute.pipeline import JaxClipEncoder
    from vln_bevbert_tpu_torch.convert import flax_to_state_dict
    from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

    # JAX's remap takes 12 layers: a narrow 12-layer tower, four patches;
    # one head, as the port reads heads off the width (64 per head)
    tower = dict(hidden_size=64, intermediate_size=64, num_layers=12, num_heads=1,
                 patch_size=16)
    torch.manual_seed(0)
    config = transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=64, num_hidden_layers=12, num_attention_heads=1,
        image_size=32, patch_size=16)
    hf = transformers.CLIPVisionModel(config).eval()
    hf.save_pretrained(tmp_path / "hf_clip")

    ours = DeviceClipEncoder.from_hf(str(tmp_path / "hf_clip"), grid_hw=2, device="cpu")
    want = flax_to_state_dict(hf_clip_to_tree(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()}))
    got = ours.tower.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)

    ref = JaxClipEncoder.from_hf(str(tmp_path / "hf_clip"), grid_hw=2, **tower)
    frames = np.random.default_rng(7).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_allclose(ours.encode_views(frames), ref.encode_views(frames), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ours.encode_grids(frames), ref.encode_grids(frames), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(OSError):  # a name that is not in the local cache: no download
        DeviceClipEncoder.from_hf("openai/clip-not-in-the-cache", device="cpu")
