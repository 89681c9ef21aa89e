"""Tests of the port's CUDA kernels; they need a card and skip without one.

On the card machine (no JAX there, and ``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import time

import pytest
import torch

from vln_bevbert_tpu_torch import _build
from vln_bevbert_tpu_torch.cli import finetune, pretrain
from vln_bevbert_tpu_torch.ops.dropout import draw_seeds, dropout, dropout_ref
from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_plain
from vln_bevbert_tpu_torch.parallel.train_step import make_pretrain_step, upload

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
@pytest.mark.parametrize("case", list(SPLAT_CASES))
def test_splat_kernel_sums_in_one_order_on_every_call_on_card(case):
    """Each cell's sum runs in the order of its points' indices: calls on
    the same input give the same sums, bit for bit, also when other work
    runs on the card between them (no atomics decide the order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, t, p, s, c, f, num_sem, dtype = SPLAT_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    store = torch.randn(b, t, p, f, generator=g, device="cuda").to(dtype)
    step_sel = (torch.stack([torch.randperm(t, generator=g, device="cuda")[:s]
                             for _ in range(b)]).int() if t > 1 else None)
    if step_sel is None:
        store = store[:, 0]
    # few cells, so that runs are long and cross many tiles
    cell = torch.randint(-1, min(c, 37), (b, s * p), generator=g, device="cuda",
                         dtype=torch.int32)
    sem = (torch.randint(0, num_sem, (b, s * p), generator=g, device="cuda", dtype=torch.int32)
           if num_sem else None)
    kw = dict(step_sel=step_sel, sem_labels=sem, num_sem=num_sem)
    first = splat_sums(cell, store, c, **kw)
    for _ in range(5):
        torch.randn(4096, 4096, device="cuda").sum()
        assert torch.equal(splat_sums(cell, store, c, **kw), first)
    plain = splat_sums_plain(cell, store, c, **kw)
    torch.testing.assert_close(first, plain, rtol=1e-5, atol=1e-3)


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


# (shape, dtype, rate, offset of x in elements) per access path of
# csrc/dropout.cu; ops.cpp picks the widest that the row length, the element
# count and x's start allow
DROPOUT_CASES = {
    "bf16_16B": ((16, 200, 768), torch.bfloat16, 0.1, 0),
    # the attention probabilities: row_len % 8 == 4, so half of the 16-byte
    # accesses hold the last group of one row and the first of the next;
    # over a wave of blocks, so every block strides
    "attention_site": ((16, 12, 441, 441), torch.bfloat16, 0.1, 0),
    # row_len % 8 == 4 and an odd row count (not a whole number of 16-byte
    # accesses), and a view 8 bytes past an aligned start
    "bf16_8B_row_len": ((3, 12, 7, 7), torch.bfloat16, 0.1, 0),
    "bf16_8B_offset": ((16, 1024), torch.bfloat16, 0.1, 4),
    # ragged rows, and views one element past an aligned start
    "scalar_ragged": ((5, 3, 7), torch.bfloat16, 0.3, 0),
    "scalar_offset_f32": ((3, 64), torch.float32, 0.5, 1),
    "scalar_offset_bf16": ((6, 40), torch.bfloat16, 0.2, 1),
    "f32_16B": ((16, 441, 768), torch.float32, 0.4, 0),
    "one_row": ((1, 1000), torch.bfloat16, 0.1, 0),
    # many short rows per block: PREVALENT's self-attention probabilities,
    # rows of 12 bf16 and of 8 float32
    "short_rows_prevalent": ((8, 12, 7, 7), torch.bfloat16, 0.1, 0),
    "short_rows_bf16": ((4096, 12), torch.bfloat16, 0.5, 0),
    "short_rows_f32": ((3000, 8), torch.float32, 0.5, 0),
    "rate_0": ((1, 1000), torch.bfloat16, 0.0, 0),
    "rate_near_1_bf16": ((16, 200, 768), torch.bfloat16, 0.999, 0),
    "rate_near_1_ragged_f32": ((7, 1003), torch.float32, 0.999, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_dropout_kernel_matches_plain_bitwise_on_card(case):
    """Forward and backward (the kernel relaunched on a fresh, aligned dy)
    equal to the plain version bit for bit, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, dtype, rate, offset = DROPOUT_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(offset + torch.Size(shape).numel(), generator=g, device="cuda")
    leaf = base.to(dtype).requires_grad_()
    x = leaf[offset:].view(shape)
    seeds = draw_seeds(shape[0], g, "cuda")
    before = _build.launches("dropout")
    y = dropout(x, seeds, rate)
    assert _build.launches("dropout") == before + 1
    assert torch.equal(y, dropout_ref(x.detach(), seeds, rate))
    if rate == 0.0:
        assert torch.equal(y, x)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    y.backward(dy)
    assert _build.launches("dropout") == before + 2
    assert torch.equal(leaf.grad[offset:].view(shape), dropout_ref(dy, seeds, rate))


@pytest.mark.cuda
def test_dropout_in_a_cuda_graph_draws_new_masks_each_replay_on_card():
    """Seeds drawn from a registered generator, the forward and the
    backward captured in one CUDA graph: two replays give two masks, each
    equal to the plain version of its seeds bit for bit, and count two
    launches each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(16, 12, 441, 441, generator=g, device="cuda").bfloat16().requires_grad_()
    dy = torch.randn(16, 12, 441, 441, generator=g, device="cuda").bfloat16()

    def step():
        seeds = draw_seeds(16, g, "cuda")
        y = dropout(x, seeds, 0.1)
        (dx,) = torch.autograd.grad(y, x, dy)
        return seeds, y, dx

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        seeds, y, dx = step()
    replays = []
    before = _build.launches("dropout")
    for _ in range(2):
        graph.replay()
        replays.append((seeds.clone(), y.clone(), dx.clone()))
    assert _build.launches("dropout") == before + 4
    assert not torch.equal(replays[0][0], replays[1][0])
    assert not torch.equal(replays[0][1] != 0, replays[1][1] != 0)
    for s, out, grad in replays:
        assert torch.equal(out, dropout_ref(x.detach(), s, 0.1))
        assert torch.equal(grad, dropout_ref(dy, s, 0.1))


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
    step_fn = make_pretrain_step(trainer.model, trainer.projector)
    for step in range(3):
        task, batch = trainer.train_loader.build_batch(step)
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = step_fn(trainer.state, upload(batch, device), task)
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
        step_fn = make_pretrain_step(trainer.model, trainer.projector)
        for step, task in enumerate(("mlm", "sap", "masksem")):
            _, batch = trainer.train_loader.build_batch(step, task=task)
            m = step_fn(trainer.state, upload(batch, torch.device(device)), task)
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


def _small_dp_configs():
    """A small float32 pretraining and fine-tuning configuration, dropout on."""
    from vln_bevbert_tpu_torch.configs import (
        FinetuneConfig,
        ModelConfig,
        OptimConfig,
        PretrainConfig,
        ShapeConfig,
    )

    model = ModelConfig(vocab_size=400, hidden_size=64, num_attention_heads=2,
                        intermediate_size=128, num_l_layers=1, num_pano_layers=1,
                        num_x_layers=1, image_feat_size=32, bev_grid_feat_size=24, bev_dim=5,
                        num_sem_classes=7, dtype="float32", max_position_embeddings=64)
    shapes = ShapeConfig(max_txt_len=16, max_steps=3, max_pano_len=8, max_gmap_len=10,
                         max_local_len=6, max_objects=0, num_views=2, grid_hw=4,
                         max_masked_tokens=4, max_pc_steps=2)
    pre = PretrainConfig(model=model, shapes=shapes, optim=OptimConfig(warmup_steps=2),
                         tasks=("mlm", "sap", "masksem"), train_batch_size=2)
    ft = FinetuneConfig(model=model, shapes=shapes, batch_size=2, max_action_len=4,
                        learning_rate=1e-4)
    return pre, ft


@pytest.mark.cuda
def test_two_gloo_ranks_pretrain_steps_match_one_process_on_card(tmp_path):
    """Two data-parallel ranks on the one card (gloo over a file store, each
    with its 2 rows of a B=4 batch) train three steps (mlm, sap, masksem,
    dropout on) as one process at B=4 on the card does: both draw the same
    dropout seeds from the CUDA generator and each rank keeps its rows', so
    losses and gradient norms agree to float32 summation order (rtol 1e-4)
    and parameters within 1e-4; every rank launches both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import dp_ranks
    from vln_bevbert_tpu.data.synthetic import synthetic_pretrain_batch

    cfg, _ = _small_dp_configs()
    batch = synthetic_pretrain_batch(np.random.default_rng(3), 4, cfg.shapes, cfg.model,
                                     with_objects=False, raw_bev=True)
    for key in ("txt_ids", "mlm_tgt", "mlm_ids"):
        batch[key] = (batch[key] % 300).astype(np.int32)
    batch["bev_mrc_masks"][:, ::2] = True
    spec = {"cfg": cfg, "seed": 7, "batch": batch, "tasks": cfg.tasks, "device": "cuda"}
    ranks = dp_ranks.run(dp_ranks.pretrain_steps, 2, str(tmp_path), spec, device="cuda:0")
    one = dp_ranks.pretrain_steps(0, 1, spec)
    for r in ranks:
        got = torch.tensor([[m["loss"], m["grad_norm"]] for m in r["metrics"]])
        want = torch.tensor([[m["loss"], m["grad_norm"]] for m in one["metrics"]])
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
        assert r["launches"]["splat"] == 3 and r["launches"]["dropout"] > 0
        for name, p in one["params"].items():
            torch.testing.assert_close(r["params"][name], p, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_two_gloo_ranks_replay_update_matches_one_process_on_card(tmp_path):
    """Two data-parallel ranks on the one card, each with 2 rows of a B=4
    replay bundle (dropout on), against one process at B=4 on the card: the
    loss at rtol 1e-4, the summed gradients at rtol 1e-3 atol 1e-5 (float32
    sums over 2 against 4 rows), the updated parameters within 2 lr (AdamW
    moves a weight whose gradient is rounding noise by up to lr either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    import dp_ranks
    from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle

    _, cfg = _small_dp_configs()
    rb = synthetic_replay_bundle(np.random.default_rng(3), cfg, 4)
    spec = {"cfg": cfg, "rb": rb, "seed": 3, "device": "cuda"}
    ranks = dp_ranks.run(dp_ranks.replay, 2, str(tmp_path), spec, device="cuda:0")
    one = dp_ranks.replay(0, 1, spec)
    for r in ranks:
        torch.testing.assert_close(torch.tensor(r["loss"]), torch.tensor(one["loss"]),
                                   rtol=1e-4, atol=0)
        assert r["launches"]["dropout"] > 0 and r["finite"]
        for name, g in one["grads"].items():
            torch.testing.assert_close(r["grads"][name], g, rtol=1e-3, atol=1e-5)
        for name, p in one["params"].items():
            torch.testing.assert_close(r["params"][name], p, rtol=0,
                                       atol=2 * cfg.learning_rate + 1e-6)


def _small_block_trainers(tmp_path, accumulation=1):
    """Two identical small float32 trainers on the card (same seed: same
    parameters and dropout generator), dropout on."""
    config = tmp_path / f"block{accumulation}.json"
    config.write_text(json.dumps({
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "float32"},
        "shapes": {"max_gmap_len": 32, "max_local_len": 8, "max_pano_len": 40,
                   "num_views": 12, "grid_hw": 4},
        "optim": {"warmup_steps": 2, "learning_rate": 1e-3,
                  "gradient_accumulation_steps": accumulation},
    }))
    return [pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "2", "--config", str(config),
        "--seed", "4", "--output_dir", str(tmp_path / f"run{i}")])) for i in range(2)]


def _replayed_losses(monkeypatch):
    """Record each pretraining graph replay's loss (a clone) into a list."""
    from vln_bevbert_tpu_torch.utils import graphs

    losses, replay = [], graphs.Graph.replay

    def recorded(self):
        out = replay(self)
        losses.append(out["loss"].clone())
        return out

    monkeypatch.setattr(graphs.Graph, "replay", recorded)
    return losses


@pytest.mark.cuda
@pytest.mark.parametrize("accumulation", [1, 2])
def test_small_graphed_block_matches_eager_steps_on_card(tmp_path, monkeypatch, accumulation):
    """A small configuration's blocks (mlm then sap, 4 steps each) as graph
    replays against the same steps run eagerly from the same state: the
    dropout generators end in the same state (equal seeds drawn), losses at
    every step and parameters agree to float32 summation order (the splat's
    atomics), with and without gradient accumulation (two graphs a task)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.pretrain.trainer import pad_block

    eager, graphed = _small_block_trainers(tmp_path, accumulation)
    step_fn = make_pretrain_step(eager.model, eager.projector)
    losses = _replayed_losses(monkeypatch)
    want = []
    for offset, task in ((0, "mlm"), (4, "sap")):
        batches = pad_block([eager.train_loader.build_batch(offset + i, task=task)[1]
                             for i in range(4)])
        for b in batches:
            want.append(step_fn(eager.state, upload(b, torch.device("cuda")), task)["loss"])
        graphed.block_fn(graphed.state, batches, task, 4, stacked=True)
    cache = graphed.block_fn.graphs
    assert cache.captures == 2 * accumulation and cache.replays == 8
    assert graphed.state.step == eager.state.step == 8
    assert graphed.state.tx.count == eager.state.tx.count == 8 // accumulation
    gen = lambda t: t.model.feat_dropout.generator.get_state()  # noqa: E731
    assert torch.equal(gen(graphed), gen(eager))
    torch.testing.assert_close(torch.stack(losses), torch.stack(want), rtol=1e-4, atol=0)
    for a, b in zip(graphed.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_replays_are_counted_in_launch_count_on_card(tmp_path):
    """The kernels count the launches that ran, on the device: a capture
    counts none and every replay counts its own. A first block of 1 step
    launches the warm-up's and the replay's splat; a cached block of 5
    launches 5 splats and 5 times the dropout launches of an eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer, eager = _small_block_trainers(tmp_path)
    _, batch = trainer.train_loader.build_batch(0, task="sap")
    _build.reset_launches()
    make_pretrain_step(eager.model, eager.projector)(
        eager.state, upload(batch, torch.device("cuda")), "sap")
    per_step = {k: _build.launches(k) for k in ("splat", "dropout")}
    assert per_step["splat"] == 1 and per_step["dropout"] > 0
    _build.reset_launches()
    trainer.block_fn(trainer.state, batch, "sap", 1)  # warm-up, capture, one replay
    assert _build.launches("splat") == 2
    _build.reset_launches()
    trainer.block_fn(trainer.state, batch, "sap", 5)
    assert torch.ops.bevbert.launch_count("splat") == 5
    assert _build.launches("dropout") == 5 * per_step["dropout"]
    assert trainer.block_fn.graphs.captures == 1


@pytest.mark.cuda
def test_evicted_graphs_are_captured_again_and_match_eager_steps_on_card(tmp_path,
                                                                         monkeypatch):
    """A block step that keeps one graph, fed mlm, sap, mlm blocks: each
    block evicts the other task's graph and captures its own again (the
    warm-up before each capture restores the state), and the losses and
    parameters still follow the eager steps from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.parallel.train_step import make_pretrain_block_step
    from vln_bevbert_tpu_torch.pretrain.trainer import pad_block

    eager, graphed = _small_block_trainers(tmp_path)
    step_fn = make_pretrain_step(eager.model, eager.projector)
    block = make_pretrain_block_step(graphed.model, graphed.projector, graphed.state,
                                     max_graphs=1)
    losses = _replayed_losses(monkeypatch)
    want = []
    for offset, task in ((0, "mlm"), (2, "sap"), (4, "mlm")):
        batches = pad_block([eager.train_loader.build_batch(offset + i, task=task)[1]
                             for i in range(2)])
        for b in batches:
            want.append(step_fn(eager.state, upload(b, torch.device("cuda")), task)["loss"])
        block(graphed.state, batches, task, 2, stacked=True)
    counters = block.graphs.counters()
    assert (counters["captures"], counters["evictions"], counters["graphs"]) == (3, 2, 1)
    gen = lambda t: t.model.feat_dropout.generator.get_state()  # noqa: E731
    assert torch.equal(gen(graphed), gen(eager))
    torch.testing.assert_close(torch.stack(losses), torch.stack(want), rtol=1e-4, atol=0)
    for a, b in zip(graphed.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _phase_names(slots) -> list:
    from vln_bevbert_tpu_torch.utils import profiling

    names = {i: n for n, i in profiling._PHASE_IDS.items()}
    return [names[i] for i in slots[:, 0].tolist()]


@pytest.mark.cuda
def test_a_captured_steps_stamps_fill_one_set_of_slots_per_replay_on_card(tmp_path):
    """A block step captured under a recorder with device phases: each
    replay takes one set of slots (forward, backward, optimizer, end; no
    all-reduce at one process), the phases come out once a replay, and on
    the host clock they lie inside the call that queued them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.utils import profiling

    trainer, _ = _small_block_trainers(tmp_path)
    _, batch = trainer.train_loader.build_batch(0, task="sap")
    with profiling.recording(device=torch.device("cuda")) as rec:
        trainer.block_fn(trainer.state, batch, "sap", 1)  # warm-up, capture, one replay
        rec.clear()
        t0 = time.time_ns()
        trainer.block_fn(trainer.state, batch, "sap", 5)
        torch.cuda.synchronize()
        t1 = time.time_ns()
        slots, taken = torch.ops.bevbert.stamps(False)
        assert taken == 5 * 4
        assert _phase_names(slots) == ["step.forward", "step.backward", "step.optimizer",
                                       None] * 5
        phases = rec.harvest()
    assert trainer.block_fn.graphs.captures == 1
    assert sorted(phases) == ["step.backward", "step.forward", "step.optimizer"]
    assert all(len(v) == 5 and min(v) > 0 for v in phases.values())
    assert len(rec.phase_spans) == 15 and rec.overflow == 0
    slack = rec.clock_error_ns + 10 ** 5
    assert all(t0 - slack < a < b < t1 + slack for _, a, b in rec.phase_spans)


@pytest.mark.cuda
def test_a_graph_captured_while_not_recording_writes_no_stamp_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.utils import profiling

    trainer, _ = _small_block_trainers(tmp_path)
    _, batch = trainer.train_loader.build_batch(0, task="sap")
    trainer.block_fn(trainer.state, batch, "sap", 2)  # captured with no recorder
    with profiling.recording(device=torch.device("cuda")) as rec:
        trainer.block_fn(trainer.state, batch, "sap", 3)
        _, taken = torch.ops.bevbert.stamps(False)
    assert taken == 0 and rec.phases == {} and trainer.block_fn.graphs.replays == 5


@pytest.mark.cuda
def test_stamped_phases_sum_to_the_replay_timed_by_cuda_events_on_card(tmp_path):
    """The phases of a replay add up to CUDA events around it, within 5% or
    20 us (the graph's launch and its first and last nodes lie outside the
    stamps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.utils import profiling

    trainer, _ = _small_block_trainers(tmp_path)
    _, batch = trainer.train_loader.build_batch(0, task="mlm")
    with profiling.recording(device=torch.device("cuda")) as rec:
        trainer.block_fn(trainer.state, batch, "mlm", 1)
        (graph,) = trainer.block_fn.graphs.graphs.values()
        rec.clear()
        events = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            events.append((start, end))
        phases = rec.harvest()
    for k, (start, end) in enumerate(events):
        stamped = sum(v[k] for v in phases.values())
        timed = 1e-3 * start.elapsed_time(end)
        assert abs(stamped - timed) <= max(0.05 * timed, 20e-6), (k, stamped, timed)


@pytest.mark.cuda
def test_a_host_span_lines_up_with_the_device_traces_idle_gap_on_card():
    """Spans around 20 ms host sleeps, each between two small kernels with a
    sync before the sleep, lie inside the idle gaps that the profiler's
    device trace shows there (50 us of slack), and the nearest start and
    the nearest end lie within 0.5 ms of their gap's: spans and the trace
    share one clock to within that. (A gap starts when the kernel before
    it ends and ends when the one after it starts: it holds the span, the
    sync's return and a launch, each of which can take milliseconds on a
    shared host, so only the nearest bound the clocks' difference.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from vln_bevbert_tpu_torch.utils import profiling

    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            x.add_(1)
            torch.cuda.synchronize()
            with profiling.span("sleep"):
                time.sleep(0.02)
            x.add_(1)
        torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    busy = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    gaps = [(start_ns + 1e3 * a_end, start_ns + 1e3 * b_start)
            for (_, a_end), (b_start, _) in zip(busy, busy[1:]) if b_start - a_end > 1e4]
    sleeps = rec.named("sleep")
    assert len(gaps) == len(sleeps) == 5
    leads = [s.start_ns - g0 for (g0, _), s in zip(gaps, sleeps)]
    lags = [g1 - s.end_ns for (_, g1), s in zip(gaps, sleeps)]
    assert min(leads) > -5e4 and min(lags) > -5e4, (leads, lags)
    assert min(leads) < 5e5 and min(lags) < 5e5, (leads, lags)


@pytest.mark.cuda
def test_block_runs_eagerly_under_a_gloo_group_on_card(tmp_path):
    """gloo cannot run its collectives inside a CUDA graph: a block on CUDA
    tensors, made before a gloo group and called under one, captures
    nothing and runs the eager steps, which the same steps run eagerly from
    the same state match (losses, dropout generator, parameters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.parallel import distributed

    trainer, eager = _small_block_trainers(tmp_path)
    step_fn = make_pretrain_step(eager.model, eager.projector)
    _, batch = trainer.train_loader.build_batch(0, task="sap")
    distributed.initialize("cuda:0", backend="gloo", rank=0, world_size=1,
                           init_method="file://" + str(tmp_path / "store"))
    try:
        got = trainer.block_fn(trainer.state, batch, "sap", 2)
        for _ in range(2):
            want = step_fn(eager.state, upload(batch, torch.device("cuda")), "sap")
        assert trainer.block_fn.graphs.captures == 0 and trainer.state.step == 2
    finally:
        distributed.shutdown()
    gen = lambda t: t.model.feat_dropout.generator.get_state()  # noqa: E731
    assert torch.equal(gen(trainer), gen(eager))
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-4, atol=0)
    for a, b in zip(trainer.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_small_graphed_replay_block_matches_eager_on_card():
    """A small float32 replay block (3 updates over one bundle, dropout on)
    as graph replays against the same updates run eagerly by an identical
    agent: equal generator states, losses and parameters to float32
    summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu.configs import FinetuneConfig, ModelConfig, ShapeConfig
    from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent, make_replay_block
    from vln_bevbert_tpu_torch.parallel.train_step import dropout_generators

    cfg = FinetuneConfig(
        model=ModelConfig(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                          num_l_layers=1, num_pano_layers=1, num_x_layers=1,
                          image_feat_size=32, bev_grid_feat_size=24, dtype="float32"),
        shapes=ShapeConfig(max_txt_len=32, max_pano_len=12, max_gmap_len=16,
                           max_local_len=6),
        batch_size=2, max_action_len=5, learning_rate=1e-4,
    )
    eager, graphed = (make_replay_agent(cfg, cfg.batch_size, seed=3, device="cuda")
                      for _ in range(2))
    rb = synthetic_replay_bundle(np.random.default_rng(3), cfg, cfg.batch_size)
    want = make_replay_block(eager, 3).eager(rb)
    block = make_replay_block(graphed, 3)
    got = block(rb)
    assert block.graphs.captures == 1 and block.graphs.replays == 3
    gen = lambda a: dropout_generators(a.model)[0].get_state()  # noqa: E731
    assert torch.equal(gen(graphed), gen(eager))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    for a, b in zip(graphed.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["r2r", "objects", "dp_rank"])
def test_loader_batches_are_pinned_and_equal_the_numpy_path_on_card(case, monkeypatch):
    """With a card the in-process loader collates into page-locked CPU
    tensors from the caching host allocator; their bytes equal the numpy
    path's (the CPU's, a forked worker's) for every task, with objects, and
    for one data-parallel rank's rows, which sit in blocks of their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from test_torch_pinned import small_config, small_loader

    cfg = small_config(with_objects=case == "objects")
    loader = small_loader(cfg, **(dict(n_devices=2, dp_rank=1) if case == "dp_rank" else {}))
    got = [loader.build_batch(step, task=t)[1] for step, t in enumerate(cfg.tasks)]
    monkeypatch.setattr(loader, "_pins", lambda: False)
    want = [loader.build_batch(step, task=t)[1] for step, t in enumerate(cfg.tasks)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["txt_ids"].shape[0] == cfg.train_batch_size
        for key, v in g.items():
            assert isinstance(v, torch.Tensor) and v.is_pinned(), key
            assert isinstance(w[key], np.ndarray), key
            assert np.asarray(v).dtype == w[key].dtype and v.shape == w[key].shape, key
            assert np.asarray(v).tobytes() == w[key].tobytes(), key
            if case == "dp_rank":
                assert v.untyped_storage().nbytes() == v.numel() * v.element_size(), key


@pytest.mark.cuda
def test_pad_block_keeps_pinned_batches_page_locked_on_card():
    """A block that mixes buckets pads the loader's pinned tensors into
    page-locked tensors, with the numpy padding's values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.pretrain.trainer import pad_block

    short = np.arange(6, dtype=np.float16).reshape(2, 3)
    a, b = {"x": torch.from_numpy(short).pin_memory()}, {"x": torch.ones(2, 5).half().pin_memory()}
    pa, pb = pad_block([a, b])
    assert pa["x"].is_pinned() and pb["x"] is b["x"]
    assert np.array_equal(pa["x"].numpy(), np.pad(short, [(0, 0), (0, 2)]))


@pytest.mark.cuda
def test_staged_pinned_batch_is_not_recycled_before_its_copy_runs_on_card():
    """A pinned batch staged behind a long kernel and dropped: the next
    batch's collate cannot take its blocks while the copies are queued (the
    copies recorded their events against the allocator's own tensors), so
    the static inputs hold the first batch once the card is done."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_pinned import small_config, small_loader

    from vln_bevbert_tpu_torch.utils import graphs

    loader = small_loader(small_config(batch_size=16))
    _, first = loader.build_batch(0, task="sap")
    want = {k: v.clone() for k, v in first.items()}
    cache = graphs.GraphCache()
    inputs = cache.inputs_for(first, torch.device("cuda"))
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of the card's cycles
    cache.load(inputs, first)
    grid_ptr = first["grid_fts"].data_ptr()
    del first
    _, second = loader.build_batch(1, task="sap")
    assert second["grid_fts"].data_ptr() != grid_ptr
    assert not torch.equal(second["grid_fts"], want["grid_fts"])
    torch.cuda.synchronize()
    for key, v in inputs.items():
        assert torch.equal(v.cpu(), want[key]), key
    assert cache.counters()["staged_pinned_bytes"] == cache.counters()["staged_bytes"] > 0


@pytest.mark.cuda
def test_to_device_moves_host_tensors_to_the_card_on_card():
    """``to_device`` copies a pinned or pageable CPU tensor, and a numpy
    array, to the card; a tensor already there passes through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vln_bevbert_tpu_torch.utils.device import to_device

    device = torch.device("cuda")
    host = torch.arange(12, dtype=torch.float16).reshape(3, 4)
    for x in (host.pin_memory(), host, host.numpy()):
        y = to_device(x, device)
        assert y.device.type == "cuda" and torch.equal(y.cpu(), host)
    on_card = host.cuda()
    assert to_device(on_card, device) is on_card


@pytest.mark.cuda
def test_blocked_train_after_warm_up_captures_stages_pinned_batches_on_card(tmp_path):
    """Graphs captured from the loader's batches with their trajectory
    arrays turned into numpy (as the benchmark's warm-up resizes them) key
    the same graphs as the pinned batches of the trainer's stream: a blocked
    ``train`` captures nothing more, and at least 95% of the host bytes it
    stages are already page-locked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from vln_bevbert_tpu_torch.parallel.train_step import dropout_generators
    from vln_bevbert_tpu_torch.utils import graphs

    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "float32"},
        "shapes": {"max_txt_len": 16, "max_steps": 3, "max_gmap_len": 64, "max_local_len": 8,
                   "max_pano_len": 40, "num_views": 12, "grid_hw": 4},
    }))
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "4", "--config", str(config),
        "--tasks", "mlm.1.sap.1.masksem.1", "--output_dir", str(tmp_path / "run")]))
    state, cache = trainer.state, trainer.block_fn.graphs
    step_fn = make_pretrain_step(trainer.model, trainer.projector)
    for i, task in enumerate(("mlm", "sap", "masksem")):
        _, real = trainer.train_loader.build_batch(10 ** 9 + i, task=task)
        b = {k: np.asarray(v).copy() if k.startswith("traj_") else v for k, v in real.items()}
        moves = state.tx.moves_next
        inputs = cache.inputs_for(b, torch.device("cuda"))
        cache.load(inputs, b)
        cache.capture((task, graphs.signature(b), moves), inputs,
                      lambda inputs=inputs, task=task, moves=moves:
                      step_fn(state, inputs, task, moves),
                      state.device_state(), dropout_generators(trainer.model))
    before = cache.counters()
    trainer.train(num_steps=24)
    after = cache.counters()
    assert before["captures"] == after["captures"] == 3
    assert after["replays"] - before["replays"] == 24
    staged = after["staged_bytes"] - before["staged_bytes"]
    pinned = after["staged_pinned_bytes"] - before["staged_pinned_bytes"]
    assert staged > 0 and pinned / staged >= 0.95, (pinned, staged)


@pytest.mark.cuda
def test_two_greedy_rollouts_of_one_seed_walk_the_same_paths_bit_for_bit_on_card():
    """The greedy evaluation rollout is fixed by the seed on the card, as
    the benchmark's cell ``r2r_finetune.eval`` runs it (its configuration
    at published widths, its traffic, its weights): two passes over the
    same first two batches walk identical paths and give identical fused
    logits, bit for bit, and the agent's counters move by the same counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness
    from portbench.jobs import eval as eval_job
    from portbench.jobs.pretrain import world_of

    seed, device = 2 ** 31 + 1801, torch.device("cuda")
    cell = harness.resolve("r2r_finetune.eval")
    _, agent = eval_job.program(cell, seed, world_of(cell, seed, device), device)
    agent.model.load_state_dict(eval_job.weights(cell, seed, device))
    tap = eval_job.Tap(agent, eval_job.projector_of(cell, device))
    passes, counts = [], []
    try:
        for _ in range(2):
            tap.rollouts, tap.keep = [], True
            before = agent.counters()
            agent.env.reset_epoch(shuffle=False)
            trajs = [agent.rollout(feedback="argmax", train=False)[0] for _ in range(2)]
            after = agent.counters()
            counts.append({k: after[k] - before[k] for k in after})
            passes.append((trajs, tap.rollouts))
    finally:
        tap.close()
    (trajs_a, ro_a), (trajs_b, ro_b) = passes
    assert trajs_a == trajs_b
    assert counts[0] == counts[1] and counts[0]["episodes"] == 8
    for a, b in zip(ro_a, ro_b):
        assert len(a["nav"]) == len(b["nav"]) > 0
        for x, y in zip(a["nav"], b["nav"]):
            assert torch.equal(x["logits"], y["logits"])
            assert torch.equal(x["bev_fts"], y["bev_fts"])
