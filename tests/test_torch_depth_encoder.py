"""The port's DDPPO depth tower (``vln_bevbert_tpu_torch/models/
depth_encoder.py``) and the converter's conv kernels against the JAX
package, on the CPU.

- ``convert`` carries flax conv kernels (kH, kW, I, O) into ``nn.Conv2d``
  (O, I, kH, kW) with their spatial layout: an asymmetric (3, 2) kernel and
  a square one give JAX's outputs at rtol 1e-5, atol 1e-6, and
  ``module_to_flax`` gives the tree back, GroupNorm included.
- A small encoder (baseplanes 8, stages (2, 1, 1, 1): a stem, downsample
  blocks, the compression head; 128x128 frames, a (8, 2, 2) map) from the
  JAX init tree, perturbed: the spatial map at rtol 1e-4, atol 1e-5 against
  JAX's NHWC output transposed to NCHW, the pooled features likewise.
- ``load_ddppo_ckpt`` on a torch checkpoint in the published layout
  (``actor_critic.net.visual_encoder.*`` beside a policy head) equals JAX's
  surgery; ``load_depth_params`` reads that file, a flat ``.npz`` flax tree
  and the port's own state dict alike, and ``DeviceDepthEncoder`` on the CPU
  gives ``JaxDepthEncoder``'s pooled features and JAX's unpooled map.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from chip_smoke import ddppo_checkpoint
from test_torch_finetune import perturbed
from vln_bevbert_tpu.ce import frozen as jax_frozen
from vln_bevbert_tpu.models import depth_encoder as jax_de
from vln_bevbert_tpu_torch.ce import frozen
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models import depth_encoder as de

ENC = dict(baseplanes=8, layers=(2, 1, 1, 1), after_compression_flat_size=32)
SIZE = 128
RTOL, ATOL = 1e-4, 1e-5


class FlaxConvNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(4, (3, 2), padding="VALID", name="tall")(x)
        x = fnn.GroupNorm(num_groups=2, epsilon=1e-5, name="norm")(x)
        return fnn.Conv(3, (3, 3), padding=((1, 1), (1, 1)), use_bias=False, name="square")(x)


class ConvNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.tall = nn.Conv2d(3, 4, (3, 2))
        self.norm = nn.GroupNorm(2, 4, eps=1e-5)
        self.square = nn.Conv2d(4, 3, 3, padding=1, bias=False)

    def forward(self, x):
        return self.square(self.norm(self.tall(x)))


def test_conv_kernels_convert_with_their_spatial_layout():
    x = np.random.default_rng(0).normal(size=(2, 7, 6, 3)).astype(np.float32)
    params = perturbed(jax.tree.map(np.asarray, jax.jit(FlaxConvNet().init)(jax.random.PRNGKey(0), x)))
    ref = np.asarray(FlaxConvNet().apply(params, x)).transpose(0, 3, 1, 2)
    ours = ConvNet()
    load_flax_params(ours, params["params"])
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    back = module_to_flax(ours)
    for mod, leaves in params["params"].items():
        for leaf, val in leaves.items():
            np.testing.assert_array_equal(back[mod][leaf], val, err_msg=f"{mod}.{leaf}")


def jax_encoder_params(seed=0):
    enc = jax_de.DdppoDepthEncoder(**ENC)
    params = jax.jit(enc.init)(jax.random.PRNGKey(seed), np.zeros((1, SIZE, SIZE, 1), np.float32))
    return enc, perturbed(jax.tree.map(np.asarray, params["params"]))


def depth_frames(n=3, seed=1):
    d = np.random.default_rng(seed).uniform(0.0, 1.0, (n, SIZE, SIZE, 1)).astype(np.float32)
    d[:, :7, :5] = 0.0
    return d


def test_encoder_spatial_and_pooled_match_jax():
    enc, params = jax_encoder_params()
    depth = depth_frames()
    ref = np.asarray(jax.jit(enc.apply)({"params": params}, depth))  # (B, h, w, C)
    assert ref.shape == (3, 2, 2, 8)
    ours = de.DdppoDepthEncoder(**ENC, input_size=SIZE)
    assert ours.feat_shape == (8, 2, 2)
    load_flax_params(ours, params)
    with torch.no_grad():
        got = ours(torch.from_numpy(depth)).numpy()
        got_3d = ours(torch.from_numpy(depth[..., 0])).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_3d, got)
    np.testing.assert_allclose(got.mean((2, 3)), ref.mean((1, 2)), rtol=RTOL, atol=ATOL)
    assert de.encoder_config(ours.state_dict(), SIZE) == {**ENC, "input_size": SIZE}
    assert {n for n, _ in ours.named_children() if n.endswith("_0")} == {
        "layer1_0", "layer2_0", "layer3_0", "layer4_0"}
    assert all(getattr(ours, f"layer{s}_0").downsample for s in range(1, 5))
    assert not ours.layer1_1.downsample


def test_ddppo_surgery_and_file_formats_match_jax(tmp_path):
    ckpt = ddppo_checkpoint(baseplanes=8, layers=(2, 1, 1, 1), channels=8, seed=3)
    ckpt_np = {"state_dict": {k: v.numpy() for k, v in ckpt["state_dict"].items()}}
    tree = jax_de.load_ddppo_ckpt(ckpt_np, layers=(2, 1, 1, 1))
    want = flax_to_state_dict(tree)
    got = de.load_ddppo_ckpt(ckpt)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    # the stripped layout too
    stripped = {k.split("visual_encoder.", 1)[1]: v for k, v in ckpt["state_dict"].items()
                if "visual_encoder" in k}
    assert sorted(de.load_ddppo_ckpt(stripped)) == sorted(want)

    published = tmp_path / "gibson-2plus-resnet50.pth"
    torch.save(ckpt, published)
    npz = tmp_path / "ddppo_tree.npz"
    np.savez(npz, **{"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
    own = tmp_path / "ddppo_port.pt"
    torch.save(want, own)
    for path in (published, npz, own):
        loaded = frozen.load_depth_params(str(path))
        assert sorted(loaded) == sorted(want), path
        for k, v in want.items():
            torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=f"{path}: {k}")
    assert sorted(flax_to_state_dict(jax_frozen.load_depth_params(str(npz)))) == sorted(want)
    with pytest.raises(ValueError, match="directory"):
        frozen.load_depth_params(str(tmp_path))

    # the checkpoint's tower, pooled and unpooled, on both sides
    depth = depth_frames(seed=2)
    pooled_ref = jax_frozen.JaxDepthEncoder(tree, **ENC)(depth)
    spatial_ref = np.asarray(jax.jit(jax_de.DdppoDepthEncoder(**ENC).apply)({"params": tree}, depth))
    ours = frozen.DeviceDepthEncoder(frozen.load_depth_params(str(published)), input_size=SIZE,
                                     device="cpu")
    assert ours.feat_shape == (8, 2, 2)
    np.testing.assert_allclose(ours(depth), pooled_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours(depth[..., 0]), pooled_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.spatial(depth), spatial_ref.transpose(0, 3, 1, 2), rtol=RTOL,
                               atol=ATOL)
