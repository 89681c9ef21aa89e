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
    "ce": (8, 1, 2352, 1, 121, 768, 0, torch.bfloat16),
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


@pytest.mark.cuda
def test_small_replay_update_matches_cpu_on_card(monkeypatch):
    """A small float32 DAgger replay update (dropout on) on the card and on
    the CPU from the same parameters, bundle and dropout seeds: the card's
    kernels (dropout forward and backward) and the CPU's plain version mask
    alike, so loss and gradient norm agree to float32 summation order (rtol
    1e-4) and the updated parameters within atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu.configs import FinetuneConfig, ModelConfig, ShapeConfig
    from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    cfg = FinetuneConfig(
        model=ModelConfig(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                          num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                          image_feat_size=32, bev_grid_feat_size=24, dtype="float32"),
        shapes=ShapeConfig(max_txt_len=32, max_pano_len=12, max_gmap_len=16,
                           max_local_len=6, max_objects=0),
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
