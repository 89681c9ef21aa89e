"""Tests of the port's CUDA kernels; they need a card and skip without one.

On the card machine (no JAX there, and ``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json

import pytest
import torch

from vln_bevbert_tpu_torch import _build
from vln_bevbert_tpu_torch.cli import finetune, pretrain
from vln_bevbert_tpu_torch.ops.dropout import draw_seeds, dropout, dropout_ref
from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_plain
from vln_bevbert_tpu_torch.parallel.train_step import upload

# (B, T, P, S, C, F, num_sem, dtype): T > 1 reads a (B, T, P, F) store
# through a (B, S) step_sel, T == 1 a (B, S * P, F) tensor
SPLAT_CASES = {
    "nav": (4, 15, 2352, 8, 441, 768, 0, torch.bfloat16),
    "pretrain": (16, 1, 2352, 1, 441, 768, 40, torch.float16),
    "ce": (8, 15, 2352, 8, 121, 768, 0, torch.bfloat16),          # a CE rollout step
    "ce_pretrain": (16, 1, 2352, 1, 121, 768, 40, torch.float16),
    "f32_feats": (3, 1, 1000, 1, 441, 768, 0, torch.float32),
    "repeated_step": (2, 4, 700, 3, 441, 768, 0, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLAT_CASES))
def test_splat_kernel_matches_plain_on_card(case):
    """The fused splat against its plain version (gather, concat,
    ``index_add_``): count and one-hot columns exact, feature sums within
    rtol 1e-5 and atol 1e-3 (float32 sums in another order). Every case has
    an all-invalid row and cells out of range. Runs where there is a card
    (``pytest -m cuda``); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, t, p, s, c, f, num_sem, dtype = SPLAT_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)
    store = torch.randn(b, t, p, f, generator=g, device="cuda").to(dtype)
    if case == "repeated_step":
        step_sel = torch.tensor([[1, 1, 3], [0, 2, 0]], dtype=torch.int32, device="cuda")
    elif t > 1:
        step_sel = torch.stack([torch.randperm(t, generator=g, device="cuda")[:s]
                                for _ in range(b)]).int()
    else:
        step_sel, store = None, store[:, 0]
    n = s * p
    cell = torch.randint(-1, c + 3, (b, n), generator=g, device="cuda", dtype=torch.int32)
    cell[0] = -1
    sem = (torch.randint(0, num_sem, (b, n), generator=g, device="cuda", dtype=torch.int32)
           if num_sem else None)
    kw = dict(step_sel=step_sel, sem_labels=sem, num_sem=num_sem)
    before = _build.launches("splat")
    out = splat_sums(cell, store, c, **kw)
    assert _build.launches("splat") == before + 1
    ref = splat_sums_plain(cell, store, c, **kw)
    assert out.shape == ref.shape == (b, c, f + num_sem + 1)
    torch.testing.assert_close(out[..., f:], ref[..., f:], atol=0, rtol=0)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert not out[0].any()


@pytest.mark.cuda
def test_splat_wrapper_rejects_bad_input_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = torch.zeros(2, 8, dtype=torch.int32, device="cuda")
    feats = torch.ones(2, 8, 16, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        splat_sums(cell.long(), feats, 4)
    with pytest.raises(TypeError):
        splat_sums(cell, feats.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        splat_sums(cell, feats.transpose(0, 1).contiguous().transpose(0, 1), 4)
    with pytest.raises(ValueError, match="range"):
        splat_sums(cell, feats, 5000)
    with pytest.raises(ValueError, match="aligned"):
        splat_sums(cell, feats[..., :12].contiguous(), 4)
    with pytest.raises(ValueError, match="CUDA"):
        splat_sums(cell, feats.cpu(), 4)


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
    _, _, val_envs, agent = finetune.build(args)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,rate,offset", [
    ((16, 200, 768), torch.bfloat16, 0.1, 0),     # hidden activations: vector path
    ((16, 441, 768), torch.float32, 0.4, 0),      # feat_dropout of the BEV features
    ((5, 3, 7), torch.bfloat16, 0.3, 0),          # row length 21: scalar path
    ((3, 64), torch.float32, 0.5, 1),             # misaligned start: scalar path
    ((1, 1000), torch.bfloat16, 0.0, 0),          # one row; rate 0 is the identity
])
def test_dropout_kernel_matches_plain_bitwise_on_card(shape, dtype, rate, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(offset + torch.Size(shape).numel(), generator=g, device="cuda")
    x = base.to(dtype)[offset:].view(shape)
    seeds = draw_seeds(shape[0], g, "cuda")
    before = _build.launches("dropout")
    y = dropout(x, seeds, rate)
    assert _build.launches("dropout") == before + 1
    assert torch.equal(y, dropout_ref(x, seeds, rate))
    if rate == 0.0:
        assert torch.equal(y, x)


@pytest.mark.cuda
def test_dropout_backward_relaunches_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(16, 12, 64, 64, generator=g, device="cuda").bfloat16().requires_grad_()
    seeds = draw_seeds(16, g, "cuda")
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                  lambda t: t):
        y = dropout(x, seeds, 0.1)
    assert len(packed) == 1 and packed[0] is seeds
    before = _build.launches("dropout")
    dy = torch.randn_like(y)
    y.backward(dy)
    assert _build.launches("dropout") == before + 1  # counted in C++, backward too
    assert torch.equal(x.grad, dropout_ref(dy, seeds, 0.1))
    assert torch.equal(x.grad != 0, (y != 0) & (dy != 0))  # the forward's mask


@pytest.mark.cuda
def test_train_step_queues_device_work_without_a_host_sync(tmp_path):
    """A full-width pretraining step (upload, lift-splat, forward with dropout,
    backward, clip, AdamW) never waits for the card before the trainer reads
    its metrics (sync debug mode "error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--num_steps", "1", "--batch_size", "16",
        "--output_dir", str(tmp_path)]))
    trainer.train()  # warm-up: cuBLAS handles, allocator
    device = torch.device("cuda")
    for step in range(3):
        task, batch = trainer.train_loader.build_batch(step)
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = trainer.step_fn(trainer.state, upload(batch, device), task)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        values = torch.stack([v.float() for v in metrics.values()])
        assert torch.isfinite(values).all(), task


@pytest.mark.cuda
def test_small_train_steps_match_cpu_on_card(tmp_path, monkeypatch):
    """A small float32 configuration trained three steps (mlm, sap, masksem)
    on the card and on the CPU from the same parameters, batches and dropout
    seeds: the card's kernels (dropout forward and backward, splat) and the
    CPU's plain versions compute the same masks and sums, so losses and
    gradient norms agree to float32 summation order (rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "float32"},
        "shapes": {"max_gmap_len": 32, "max_local_len": 8, "max_pano_len": 40,
                   "num_views": 12, "grid_hw": 4},
        "optim": {"warmup_steps": 2},
    }))
    trainers = {device: pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", device, "--batch_size", "2", "--config", str(config),
        "--output_dir", str(tmp_path)])) for device in ("cpu", "cuda")}
    cpu_model = trainers["cpu"].model
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in cpu_model.parameters():  # no all-zero biases: see test_torch_train_step.py
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    trainers["cuda"].model.load_state_dict(cpu_model.state_dict())

    draw, gens = drop_mod.draw_seeds, {}

    def shared_seeds(rows, generator, device):  # one CPU stream per device
        g = gens.setdefault(torch.device(device).type, torch.Generator().manual_seed(5))
        return draw(rows, g, "cpu").to(device)

    monkeypatch.setattr(drop_mod, "draw_seeds", shared_seeds)
    losses = {}
    for device, trainer in trainers.items():
        losses[device] = []
        for step, task in enumerate(("mlm", "sap", "masksem")):
            _, batch = trainer.train_loader.build_batch(step, task=task)
            m = trainer.step_fn(trainer.state, upload(batch, torch.device(device)), task)
            losses[device].append([float(m["loss"]), float(m["grad_norm"])])
    torch.testing.assert_close(torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
                               rtol=1e-4, atol=0)
    for a, b in zip(trainers["cuda"].model.parameters(), cpu_model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-4)


def _replay_update_on_card_and_cpu(monkeypatch, obj_feat_size=0, max_objects=0):
    """One replay update of a small float32 configuration on the card and on
    the CPU from the same parameters, bundle and dropout seeds; returns the
    two agents."""
    import numpy as np

    from vln_bevbert_tpu.configs import FinetuneConfig, ModelConfig, ShapeConfig
    from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    cfg = FinetuneConfig(
        model=ModelConfig(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                          num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                          image_feat_size=32, bev_grid_feat_size=24, dtype="float32",
                          obj_feat_size=obj_feat_size),
        shapes=ShapeConfig(max_txt_len=32, max_pano_len=12, max_gmap_len=16,
                           max_local_len=6, max_objects=max_objects),
        batch_size=2, max_action_len=5, learning_rate=1e-4,
    )
    agents = {d: make_replay_agent(cfg, cfg.batch_size, device=d) for d in ("cpu", "cuda")}
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in agents["cpu"].model.parameters():  # no all-zero biases
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    agents["cuda"].model.load_state_dict(agents["cpu"].model.state_dict())

    draw, gens = drop_mod.draw_seeds, {}

    def shared_seeds(rows, generator, device):  # one CPU stream per device
        g = gens.setdefault(torch.device(device).type, torch.Generator().manual_seed(5))
        return draw(rows, g, "cpu").to(device)

    monkeypatch.setattr(drop_mod, "draw_seeds", shared_seeds)
    rb = synthetic_replay_bundle(np.random.default_rng(3), cfg, cfg.batch_size)
    before = _build.launches("dropout")
    for agent in agents.values():
        agent.learn_from_bundle(rb)
    assert _build.launches("dropout") > before
    cpu, card = agents["cpu"], agents["cuda"]
    torch.testing.assert_close(
        torch.tensor(card.logs["IL_loss"] + card.logs["grad_norm"]),
        torch.tensor(cpu.logs["IL_loss"] + cpu.logs["grad_norm"]), rtol=1e-4, atol=0)
    for a, b in zip(card.model.parameters(), cpu.model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4)
    return agents


@pytest.mark.cuda
def test_small_replay_update_matches_cpu_on_card(monkeypatch):
    """A small float32 DAgger replay update (dropout on) on the card and on
    the CPU from the same parameters, bundle and dropout seeds: the card's
    kernels (dropout forward and backward) and the CPU's plain version mask
    alike, so loss and gradient norm agree to float32 summation order (rtol
    1e-4) and the updated parameters within atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _replay_update_on_card_and_cpu(monkeypatch)


@pytest.mark.cuda
def test_small_object_replay_update_matches_cpu_on_card(monkeypatch):
    """The same with REVERIE object slots (their own ``obj_linear``, four
    objects a panorama): the object tokens' dropout, the object cross-entropy
    and ``og_head`` agree on the card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    agents = _replay_update_on_card_and_cpu(monkeypatch, obj_feat_size=40, max_objects=4)
    assert agents["cuda"].model.og_head is not None


def _small_ce_agents(use_bev=True):
    """A small float32 CE configuration (hidden 64, BEV 5, B=2) on the card
    and on the CPU with the same navigation and waypoint parameters. The
    waypoint head is sharpened (x100) so that the NMS peaks of its heatmap
    stand far apart: float32 sums in another order cannot reorder them."""
    import numpy as np

    from vln_bevbert_tpu_torch.ce.agent import CEAgent
    from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
    from vln_bevbert_tpu_torch.configs import FinetuneConfig, ModelConfig, ShapeConfig

    cfg = FinetuneConfig(
        model=ModelConfig(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                          num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                          image_feat_size=32, bev_grid_feat_size=24, bev_dim=5, bev_res=1.5,
                          dtype="float32", use_bev=use_bev),
        shapes=ShapeConfig(max_txt_len=32, max_pano_len=20, max_gmap_len=16, max_local_len=8,
                           num_views=12, grid_hw=4, max_pc_steps=3),
        batch_size=2, max_action_len=4, learning_rate=1e-4,
        fusion="avg" if use_bev else "global")
    agents = {}
    for device in ("cpu", "cuda"):
        env = SyntheticContinuousEnv(
            make_synthetic_ce_episodes(np.random.default_rng(3), n=4),
            batch_size=2, grid_hw=4, grid_feat_size=24, view_feat_size=32,
            depth_feat_shape=(8, 2, 2), obstacles=[(3.0, 3.0, 0.4)])
        agents[device] = CEAgent(cfg, env, device=device)
        agents[device].init_params()
    cpu = agents["cpu"]
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in cpu.model.parameters():  # no all-zero biases
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        cpu.wp_model.cls_fc2.weight.mul_(100.0)
    agents["cuda"].model.load_state_dict(cpu.model.state_dict())
    agents["cuda"].wp_model.load_state_dict(cpu.wp_model.state_dict())
    return agents


@pytest.mark.cuda
@pytest.mark.parametrize("use_bev", [True, False], ids=["ss_bev", "ss_etp"])
def test_small_ce_rollout_matches_cpu_on_card(use_bev):
    """Greedy CE rollouts with low-level control (B=2, 4 steps) on the card
    and on the CPU, float32: equal positions and headings, heatmaps within
    1e-4 and fused logits within 1e-3; on the card the splat launches once
    per gather-and-splat call, and never without the BEV branch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.ce import agent as ce_agent

    agents = _small_ce_agents(use_bev)
    rec, gather = {}, ce_agent.gather_and_splat
    calls = {"n": 0}

    def counted(*args):
        calls["n"] += 1
        return gather(*args)

    trajs = {}
    try:
        ce_agent.gather_and_splat = counted
        for device, agent in agents.items():
            rec[device] = {"heat": [], "logits": []}
            waypoints, forward = agent._waypoints, agent._forward

            def wp_rec(obs, train, waypoints=waypoints, out=rec[device]):
                res = waypoints(obs, train)
                out["heat"].append(res[2])
                return res

            def fwd_rec(mode, batch, forward=forward, out=rec[device]):
                res = forward(mode, batch)
                if mode == "navigation":
                    out["logits"].append(res["fused_logits"].float().cpu().numpy())
                return res

            agent._waypoints, agent._forward = wp_rec, fwd_rec
            calls["n"] = 0
            before = _build.launches("splat")
            trajs[device] = [agent.rollout(feedback="argmax", train=False)[0] for _ in range(2)]
            if device == "cuda":
                assert _build.launches("splat") - before == calls["n"]
                assert (calls["n"] > 0) == use_bev
    finally:
        ce_agent.gather_and_splat = gather
    for a, b in zip(sum(trajs["cuda"], []), sum(trajs["cpu"], [])):
        np.testing.assert_array_equal(np.stack(a["positions"]), np.stack(b["positions"]))
        assert a["headings"] == b["headings"]
    for key, tol in (("heat", 1e-4), ("logits", 1e-3)):
        assert len(rec["cuda"][key]) == len(rec["cpu"][key]) > 0
        for a, b in zip(rec["cuda"][key], rec["cpu"][key]):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _small_towers(device, tmp_path):
    """A small CLIP (hidden 64, 2 layers, 64x64 frames) and DDPPO (baseplanes
    8, a block per stage, 128x128 depth) from chip_smoke's seeded
    checkpoints, on ``device``."""
    import chip_smoke
    from vln_bevbert_tpu_torch.ce.frozen import (DeviceDepthEncoder, load_clip_params,
                                                 load_depth_params)
    from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

    clip, ddppo = tmp_path / "clip.pt", tmp_path / "ddppo.pth"
    if not clip.exists():
        torch.save(chip_smoke.hf_clip_state_dict(64, 128, 2, 16, 64, seed=1), clip)
        torch.save(chip_smoke.ddppo_checkpoint(8, (1, 1, 1, 1), 32, seed=2), ddppo)
    return (DeviceClipEncoder(load_clip_params(str(clip)), grid_hw=4, device=device),
            DeviceDepthEncoder(load_depth_params(str(ddppo)), input_size=128, device=device))


@pytest.mark.cuda
def test_small_towers_match_cpu_on_card(tmp_path, monkeypatch):
    """The small CLIP and DDPPO towers on the card and on the CPU with the
    same parameters, in strict float32 (TF32 off for cuDNN, as the CE CLI
    sets it): pooled features, grids and the DDPPO map within rtol 1e-4 and
    atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, 64, 64, 3), dtype=np.uint8)
    depth = rng.uniform(0, 1, (12, 128, 128)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        clip, ddppo = _small_towers(device, tmp_path)
        out[device] = (clip.encode_views(frames), clip.encode_grids(frames),
                       ddppo.spatial(depth), ddppo(depth))
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert out["cuda"][2].shape == (12, 32, 2, 2)


@pytest.mark.cuda
def test_small_habitat_ce_rollout_matches_cpu_on_card(tmp_path, monkeypatch):
    """Greedy SS-BEV rollouts with low-level control over chip_smoke's
    stand-in habitat, the small towers rendering each step's ring, on the
    card and on the CPU from the same parameters: equal positions and
    headings, heatmaps within 1e-4 and fused logits within 1e-3; the splat
    launches once per gather-and-splat call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys

    import numpy as np

    import chip_smoke
    from vln_bevbert_tpu_torch.ce import agent as ce_agent
    from vln_bevbert_tpu_torch.ce.agent import CEAgent
    from vln_bevbert_tpu_torch.ce.habitat_binding import make_habitat_env
    from vln_bevbert_tpu_torch.configs import FinetuneConfig, ModelConfig, ShapeConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setitem(sys.modules, "habitat", chip_smoke.habitat_stand_in())
    config = chip_smoke.write_habitat_config(str(tmp_path / "h.yaml"), rgb_hw=64, depth_hw=128,
                                             episodes=4)
    cfg = FinetuneConfig(
        model=ModelConfig(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                          num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                          image_feat_size=32, bev_grid_feat_size=64, bev_dim=5, bev_res=1.5,
                          dtype="float32"),
        shapes=ShapeConfig(max_txt_len=64, max_pano_len=20, max_gmap_len=16, max_local_len=8,
                           num_views=12, grid_hw=4, max_pc_steps=3),
        batch_size=2, max_action_len=4, learning_rate=1e-4, fusion="avg")
    agents = {}
    for device in ("cpu", "cuda"):
        clip, ddppo = _small_towers(device, tmp_path)
        env = make_habitat_env(config, 2, clip_encoder=clip, depth_encoder=ddppo, grid_hw=4)
        agents[device] = CEAgent(cfg, env, device=device)
        agents[device].init_params()
    cpu = agents["cpu"]
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in cpu.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        cpu.wp_model.cls_fc2.weight.mul_(100.0)
    agents["cuda"].model.load_state_dict(cpu.model.state_dict())
    agents["cuda"].wp_model.load_state_dict(cpu.wp_model.state_dict())
    rec, gather, calls, trajs = {}, ce_agent.gather_and_splat, {"n": 0}, {}

    def counted(*args):
        calls["n"] += 1
        return gather(*args)

    try:
        ce_agent.gather_and_splat = counted
        for device, agent in agents.items():
            rec[device] = {"heat": [], "logits": []}
            waypoints, forward = agent._waypoints, agent._forward

            def wp_rec(obs, train, waypoints=waypoints, out=rec[device]):
                res = waypoints(obs, train)
                out["heat"].append(res[2])
                return res

            def fwd_rec(mode, batch, forward=forward, out=rec[device]):
                res = forward(mode, batch)
                if mode == "navigation":
                    out["logits"].append(res["fused_logits"].float().cpu().numpy())
                return res

            agent._waypoints, agent._forward = wp_rec, fwd_rec
            calls["n"] = 0
            before = _build.launches("splat")
            trajs[device] = agent.rollout(feedback="argmax", train=False)[0]
            if device == "cuda":
                assert _build.launches("splat") - before == calls["n"] > 0
    finally:
        ce_agent.gather_and_splat = gather
    for a, b in zip(trajs["cuda"], trajs["cpu"]):
        np.testing.assert_array_equal(np.stack(a["positions"]), np.stack(b["positions"]))
        assert a["headings"] == b["headings"]
    for key, tol in (("heat", 1e-4), ("logits", 1e-3)):
        assert len(rec["cuda"][key]) == len(rec["cpu"][key]) > 0
        for a, b in zip(rec["cuda"][key], rec["cpu"][key]):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
def test_small_ce_replay_update_matches_cpu_on_card(monkeypatch):
    """A teacher-forced CE training rollout and its replay update (dropout
    on) on the card and on the CPU from the same parameters and dropout
    seeds: equal trajectories, loss and gradient norm within rtol 1e-4, the
    updated parameters within atol 1e-4; the frozen predictor unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    agents = _small_ce_agents()
    draw, gens = drop_mod.draw_seeds, {}

    def shared_seeds(rows, generator, device):  # one CPU stream per device
        g = gens.setdefault(torch.device(device).type, torch.Generator().manual_seed(5))
        return draw(rows, g, "cpu").to(device)

    monkeypatch.setattr(drop_mod, "draw_seeds", shared_seeds)
    wp_before = {n: p.detach().cpu().clone() for n, p in agents["cuda"].wp_model.named_parameters()}
    before = _build.launches("dropout")
    trajs = {d: a.rollout(feedback="teacher", train=True)[0] for d, a in agents.items()}
    assert _build.launches("dropout") > before
    for a, b in zip(trajs["cuda"], trajs["cpu"]):
        np.testing.assert_array_equal(np.stack(a["positions"]), np.stack(b["positions"]))
    cpu, card = agents["cpu"], agents["cuda"]
    assert len(card.logs["IL_loss"]) == 1 and card.logs["IL_loss"][0] > 0
    torch.testing.assert_close(
        torch.tensor(card.logs["IL_loss"] + card.logs["grad_norm"]),
        torch.tensor(cpu.logs["IL_loss"] + cpu.logs["grad_norm"]), rtol=1e-4, atol=0)
    for a, b in zip(card.model.parameters(), cpu.model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4)
    for n, p in card.wp_model.named_parameters():
        assert torch.equal(p.detach().cpu(), wp_before[n]), n


def _shared_dropout_seeds(monkeypatch):
    """Dropout seeds from one CPU stream per device type, the same on both."""
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    draw, gens = drop_mod.draw_seeds, {}

    def shared_seeds(rows, generator, device):
        g = gens.setdefault(torch.device(device).type, torch.Generator().manual_seed(5))
        return draw(rows, g, "cpu").to(device)

    monkeypatch.setattr(drop_mod, "draw_seeds", shared_seeds)


@pytest.mark.cuda
def test_small_prevalent_update_matches_cpu_on_card(monkeypatch, tmp_path):
    """The PREVALENT policy (hidden 64, float32, dropout on) on the card and
    on the CPU from the same parameters: a collection at beta 1 stores equal
    episodes; one BPTT update from the stacked store with the same dropout
    seeds gives the loss and gradient norm within rtol 1e-4 and parameters
    within atol 1e-4; the dropout kernel launches on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.ce.dagger import DaggerEpisodeStore, PrevalentDaggerAgent
    from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
    from vln_bevbert_tpu_torch.configs import FinetuneConfig, ModelConfig

    cfg = FinetuneConfig(model=ModelConfig(hidden_size=64, num_attention_heads=2,
                                           intermediate_size=128, image_feat_size=32,
                                           dtype="float32"),
                         batch_size=2, max_action_len=4, learning_rate=1e-4)
    agents, stores = {}, {}
    for device in ("cpu", "cuda"):
        env = SyntheticContinuousEnv(make_synthetic_ce_episodes(np.random.default_rng(3), n=4),
                                     batch_size=2, grid_hw=4, grid_feat_size=24,
                                     view_feat_size=32, depth_feat_shape=(8, 2, 2))
        agents[device] = PrevalentDaggerAgent(cfg, env, device=device)
        agents[device].init_params()
    cpu, card = agents["cpu"], agents["cuda"]
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in cpu.model.parameters():  # no all-zero biases
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        cpu.wp_model.cls_fc2.weight.mul_(100.0)
    card.model.load_state_dict(cpu.model.state_dict())
    card.wp_model.load_state_dict(cpu.wp_model.state_dict())
    for device, agent in agents.items():
        stores[device] = DaggerEpisodeStore(str(tmp_path / device))
        assert agent.collect(stores[device], 1, beta=1.0) == 2
    for i in range(2):
        a, b = stores["cuda"].get(i), stores["cpu"].get(i)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    batch = next(stores["cpu"].iter_batches(2, np.random.default_rng(0)))
    _shared_dropout_seeds(monkeypatch)
    before = _build.launches("dropout")
    out = {d: torch.stack(a._update(batch)).tolist() for d, a in agents.items()}
    assert _build.launches("dropout") > before
    torch.testing.assert_close(torch.tensor(out["cuda"]), torch.tensor(out["cpu"]), rtol=1e-4,
                               atol=0)
    for a, b in zip(card.model.parameters(), cpu.model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_small_dagger_bev_store_update_matches_cpu_on_card(monkeypatch, tmp_path):
    """The glocal CE agent's DAgger store on the card and on the CPU: a
    collection at beta 1 spills equal bundles (BEV features within 1e-4,
    float32 on disk), the splat launching once per gather-and-splat call;
    an epoch over the store with the same dropout seeds gives losses within
    rtol 1e-4 and parameters within atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.ce import agent as ce_mod
    from vln_bevbert_tpu_torch.nav.recollection import TeacherRecollectionStore

    agents = _small_ce_agents()
    gathers = []
    gather = ce_mod.gather_and_splat
    monkeypatch.setattr(ce_mod, "gather_and_splat",
                        lambda *a: gathers.append(a[1].device.type) or gather(*a))
    stores = {d: TeacherRecollectionStore(a, spill_dir=str(tmp_path / d))
              for d, a in agents.items()}
    before = _build.launches("splat")
    for store in stores.values():
        assert store.collect(1, beta=1.0) == 1
    assert _build.launches("splat") - before == gathers.count("cuda") > 0
    a, b = stores["cuda"]._get(0), stores["cpu"]._get(0)
    assert sorted(a) == sorted(b) and a["bev_fts"].dtype == np.float32
    for key in b:
        if key == "bev_fts":
            np.testing.assert_allclose(a[key], b[key], atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    _shared_dropout_seeds(monkeypatch)
    before = _build.launches("dropout")
    losses = {d: s.train_epochs(1, rng=np.random.default_rng(0)) for d, s in stores.items()}
    assert _build.launches("dropout") > before
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for p, q in zip(agents["cuda"].model.parameters(), agents["cpu"].model.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0, atol=1e-4)


OPTIMIZERS = ["radam", "lamb", "ralamb", "rangerlars", "adam", "adamax", "adamw+ema",
              "adamw+lookahead", "ralamb+lookahead"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_family_matches_cpu_on_card(name, k):
    """Each optimizer (and gradient accumulation over 2 steps) on a small
    ``BertLayer`` and ``Embed``, 3 updates from the same parameters and
    gradients on the card and the CPU: parameters within 1e-5 (float32
    reductions in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch import nn

    from vln_bevbert_tpu_torch.configs import ModelConfig, OptimConfig
    from vln_bevbert_tpu_torch.models.bert import BertLayer, Embed
    from vln_bevbert_tpu_torch.parallel.train_step import TrainState

    cfg = ModelConfig(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                      dtype="float32")
    g = torch.Generator().manual_seed(0)
    models, states = {}, {}
    for device in ("cpu", "cuda"):
        model = nn.ModuleDict({"layer": BertLayer(cfg), "emb": Embed(cfg, 50)})
        g.manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        models[device] = model.to(device)
        states[device] = TrainState(models[device], OptimConfig(
            optim=name, learning_rate=0.01, warmup_steps=2, num_train_steps=10,
            gradient_accumulation_steps=k))
    for _ in range(3 * k):
        grads = [torch.randn(p.shape, generator=g) for p in models["cpu"].parameters()]
        for device, model in models.items():
            for p, grad in zip(model.parameters(), grads):
                p.grad.copy_(grad)
            states[device].apply_gradients()
    assert states["cuda"].tx.count == 3
    for a, b in zip(models["cuda"].parameters(), models["cpu"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_small_validate_matches_cpu_on_card(tmp_path):
    """``validate`` of a small float32 configuration on the card and on the
    CPU with the same parameters and batches: every metric within 1e-4 (the
    splat kernel's and the plain version's sums, float32 in another order),
    no dropout launch on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "float32"},
        "shapes": {"max_gmap_len": 32, "max_local_len": 8, "max_pano_len": 40,
                   "num_views": 12, "grid_hw": 4},
    }))
    trainers = {device: pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", device, "--batch_size", "4", "--config", str(config),
        "--output_dir", str(tmp_path / device)])) for device in ("cpu", "cuda")}
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for p in trainers["cpu"].model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    before = _build.launches("dropout")
    results = {d: t.validate(step=1, num_batches=2) for d, t in trainers.items()}
    assert _build.launches("dropout") == before
    assert sorted(results["cuda"]) == sorted(results["cpu"])
    assert "val_unseen/sem/auc_macro" in results["cuda"]
    for key, val in results["cpu"].items():
        assert abs(results["cuda"][key] - val) <= 1e-4, (key, results["cuda"][key], val)
