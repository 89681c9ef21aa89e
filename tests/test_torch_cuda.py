"""Tests of the port's CUDA kernels; they need a card and skip without one.

On the card machine (no JAX there, and ``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json

import pytest
import torch

from vln_bevbert_tpu_torch.cli import finetune
from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_ref


@pytest.mark.cuda
def test_splat_kernel_matches_plain_on_card():
    """Runs where there is a card (``pytest -m cuda``); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    cell = torch.randint(-1, 441, (4, 5000), generator=g, device="cuda", dtype=torch.int32)
    payload = torch.randn(4, 5000, 769, generator=g, device="cuda").to(torch.bfloat16)
    payload[..., -1] = 1.0                     # the count column
    before = splat_sums.launches
    out = splat_sums(cell, payload, 441)
    assert splat_sums.launches == before + 1
    ref = splat_sums_ref(cell, payload, 441)
    torch.testing.assert_close(out[..., -1], ref[..., -1], atol=0, rtol=0)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_splat_wrapper_rejects_bad_input_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    payload = torch.ones(2, 8, 3, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        splat_sums(cell.long(), payload, 4)
    with pytest.raises(TypeError):
        splat_sums(cell, payload.float(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        splat_sums(cell, payload.transpose(0, 1).contiguous().transpose(0, 1), 4)
    with pytest.raises(ValueError, match="range"):
        splat_sums(cell, payload, 5000)
    with pytest.raises(ValueError, match="CUDA"):
        splat_sums(cell, payload.cpu(), 4)


@pytest.mark.cuda
def test_rollout_step_queues_device_work_until_the_pano_read(tmp_path):
    """Nothing in a step waits for the card between queueing the panorama
    forward and the first host read of its result, and no forward waits:
    the host work overlaps the device work (sync debug mode "error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "bfloat16"},
        "shapes": {"max_gmap_len": 32, "max_local_len": 8, "num_views": 12,
                   "grid_hw": 4, "max_pc_steps": 4},
        "batch_size": 2, "max_action_len": 4,
    }))
    args = finetune.parse_args(["--synthetic", "--test", "--device", "cuda",
                                "--config", str(config), "--output_dir", str(tmp_path)])
    _, val_envs, agent = finetune.build(args)
    agent.env = val_envs["val_unseen"]
    agent.rollout()  # warm-up
    forward, fuse_map = agent._forward, agent._build_fuse_map
    checked = []

    def checked_forward(mode, batch):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = forward(mode, batch)
        except BaseException:
            torch.cuda.set_sync_debug_mode(0)
            raise
        if mode != "panorama":  # the pano result is read after the fuse map
            torch.cuda.set_sync_debug_mode(0)
        checked.append(mode)
        return out

    def fuse_map_then_allow_sync(*a):
        try:
            return fuse_map(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    agent._forward, agent._build_fuse_map = checked_forward, fuse_map_then_allow_sync
    try:
        trajs, _ = agent.rollout()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(trajs) == 2
    assert checked.count("panorama") == checked.count("navigation") >= 1
