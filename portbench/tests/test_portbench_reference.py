"""The plain reference against the program's own modules, at a tiny width on
the CPU: the frozen batch builder against the program's loader, the
model's loss and gradients against the program's model in float32 with the
same weights and dropout seeds, the navigation logits, the BEV splat and the
dropout mask."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.jobs import dagger as dagger_job
from portbench.jobs import pretrain as job
from portbench.reference import bev as rbev
from portbench.reference import data as rdata
from portbench.reference import dropout as rdrop
from portbench.reference import model as rmodel
from portbench.reference import train as rtrain
from portbench.reference.config import settings
from portbench.tests.tiny import make_root

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def cell(root):
    return harness.resolve("tiny_pretrain.tiny_mix", root)


@pytest.fixture(scope="module")
def world(cell):
    return job.world_of(cell, SEED)


def float32(cfg):
    cfg.model.dtype = "float32"
    cfg.optim.mu_dtype = "float32"
    return cfg


def test_reference_batches_equal_the_program_loaders(cell, world):
    from vln_bevbert_tpu_torch.data.loader import PretrainLoader

    cfg = job.program_config(cell, SEED)
    loader = PretrainLoader(job.program_db(cfg, world), cfg, seed=SEED, prefetch=0)
    m, s = settings(cell.config["run"])
    db = rdata.text_path_data(world, m, s)
    for step, task in ((0, None), (1, None), (8, None), (17, None), (3, "masksem")):
        task, batch = loader.build_batch(step, task=task)
        ref_task, ref = rdata.build_batch(db, cell.config["run"], m, s, SEED, step, task=task)
        assert ref_task == task
        assert sorted(ref) == sorted(batch)
        for key in batch:
            np.testing.assert_array_equal(ref[key], batch[key], err_msg=key)


@pytest.mark.parametrize("task", ["mlm", "sap", "masksem"])
def test_reference_loss_and_gradients_match_the_program_in_float32(cell, world, task):
    from vln_bevbert_tpu_torch.ops.dropout import set_dropout_generator
    from vln_bevbert_tpu_torch.parallel.train_step import (
        init_pretrain_state, make_loss_fn, upload)

    cfg = float32(job.program_config(cell, SEED))
    model, projector, _ = init_pretrain_state(cfg, SEED, "cpu")
    weights = job.weights(cell, SEED, "cpu")
    model.load_state_dict(weights)
    set_dropout_generator(model, torch.Generator().manual_seed(7))
    m, s = settings(cell.config["run"])
    db = rdata.text_path_data(world, m, s)
    _, batch = rdata.build_batch(db, cell.config["run"], m, s, SEED, 0, task=task)
    # bf16-exact features: the program's splat rounds them to bf16
    batch["grid_fts"] = torch.from_numpy(batch["grid_fts"]).bfloat16().float().numpy()
    loss = make_loss_fn(model, projector)(upload(batch, torch.device("cpu")), task)[0]
    loss.backward()

    ref_model = job.reference_model(cell, rmodel.Numerics(), "cpu")
    ref_model.load_state_dict(weights)
    ref_model.train()
    rmodel.set_generator(ref_model, torch.Generator().manual_seed(7))
    ref_proj = rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res, m.num_sem_classes)
    ref_loss = job.reference_loss(ref_model, ref_proj, batch, task, "cpu")
    ref_loss.backward()
    assert loss.item() == pytest.approx(ref_loss.item(), rel=1e-6)
    grads = dict(model.named_parameters())
    for name, p in ref_model.named_parameters():
        g, r = grads[name].grad, p.grad
        if r is None:
            assert g is None or not g.any(), name
            continue
        assert torch.linalg.vector_norm(g - r) <= 1e-5 * torch.linalg.vector_norm(r) + 1e-9, name


def test_reference_adamw_past_the_warm_up_matches_the_programs(cell):
    """The checked steps' update: from the count at the end of the warm-up,
    the reference's clip-free AdamW and schedule against the program's
    optimizer, both in float32, over three updates."""
    from vln_bevbert_tpu_torch.configs import OptimConfig
    from vln_bevbert_tpu_torch.parallel.optim import Optimizer

    optim = dict(cell.config["run"]["optim"], mu_dtype="float32")
    g = torch.Generator().manual_seed(3)
    names = ["enc.dense.weight", "enc.dense.bias", "enc.out_ln.weight"]
    start = [torch.randn(5, 7, generator=g) * 0.02, torch.zeros(7), torch.ones(7)]
    grads = [[torch.randn(p.shape, generator=g) * 1e-3 for p in start] for _ in range(3)]
    prog_params = [p.clone() for p in start]
    prog = Optimizer(prog_params, [rtrain.decayed(n) for n in names],
                     OptimConfig(**{**optim, "betas": tuple(optim["betas"])}))
    count = job.check_count(cell)
    prog.set_counts(count, 0)
    ref_params = [p.clone() for p in start]
    ref = rtrain.AdamW(list(zip(names, ref_params)), optim, count=count)
    assert rtrain.lr_at(optim, count) == pytest.approx(optim["learning_rate"])
    for step in grads:
        prog.update([x.clone() for x in step])
        ref.step([x.clone() for x in step])
    for name, a, b, p0 in zip(names, prog_params, ref_params, start):
        assert not torch.equal(b, p0), name  # every leaf moves
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=name)


def test_reference_navigation_logits_match_the_program(root):
    from vln_bevbert_tpu_torch.configs import FinetuneConfig, load_config
    from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT

    cell = harness.resolve("tiny_finetune.tiny_dagger", root)
    cfg = load_config(FinetuneConfig, None, **cell.config["run"])
    cfg.model.dtype = "float32"
    prog = GlocalTextPathNavCMT(cfg.model, device="cpu").eval()
    weights = dagger_job.weights(cell, SEED, "cpu")
    prog.load_state_dict(weights)
    ref = dagger_job.nav_model(cell, rmodel.Numerics(), "cpu")
    ref.load_state_dict(weights)
    ref.eval()
    m, s = settings(cell.config["run"])
    g = torch.Generator().manual_seed(3)
    B, L, N, K, C = 2, 32, s.max_gmap_len, s.max_local_len, m.bev_dim ** 2
    batch = {
        "txt_embeds": torch.randn(B, L, m.hidden_size, generator=g),
        "txt_masks": torch.arange(L)[None] < torch.tensor([[20], [32]]),
        "gmap_img_embeds": torch.randn(B, N, m.hidden_size, generator=g),
        "gmap_step_ids": torch.randint(0, 10, (B, N), generator=g),
        "gmap_pos_fts": torch.randn(B, N, 7, generator=g),
        "gmap_masks": torch.arange(N)[None] < torch.tensor([[6], [9]]),
        "gmap_pair_dists": torch.rand(B, N, N, generator=g),
        "gmap_visited_masks": torch.arange(N)[None] == 1,
        "bev_fts": torch.randn(B, C, m.bev_grid_feat_size, generator=g),
        "bev_pos_fts": torch.randn(B, C, 10, generator=g),
        "bev_masks": torch.ones(B, C, dtype=torch.bool),
        "bev_nav_masks": torch.rand(B, C, generator=g) < 0.2,
        "bev_cand_idxs": torch.randint(0, C, (B, K), generator=g),
        "local_masks": torch.arange(K)[None] < 4,
        "fuse_map": (torch.rand(B, N, K, generator=g) < 0.1).float(),
    }
    with torch.no_grad():
        want = prog("navigation", batch)["fused_logits"]
        got = ref.navigation(batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_reference_splat_matches_the_program_projector():
    from vln_bevbert_tpu_torch.ops.bev import BevProjector

    g = torch.Generator().manual_seed(5)
    B, V, H = 3, 12, 4
    depths = torch.rand(B, V, H, H, generator=g) * 8.0
    depths[0, 0, 0, 0] = 0.0
    poses = torch.eye(4).repeat(B, V, 1, 1)
    poses[..., :3, 3] = torch.randn(B, V, 3, generator=g)
    T_w2c = torch.eye(4).repeat(B, 1, 1)
    S_w2c = torch.randn(B, 3, generator=g)
    # bf16-exact features: the program's splat rounds them to bf16
    feats = torch.randn(B, V * H * H, 16, generator=g).bfloat16().float()
    sems = torch.randint(0, 40, (B, V * H * H), generator=g)
    prog = BevProjector(grid_hw=H, num_views=V, map_dim=5, map_res=0.5)
    ref = rbev.Projector(H, V, 5, 0.5)
    want = prog.lift_splat(depths, poses, T_w2c, S_w2c, feats, sems)
    got = ref.lift_splat(depths, poses, T_w2c, S_w2c, feats, sems)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[2])
    assert torch.equal(got[2], want[3])


def test_reference_dropout_is_the_programs_mask_bit_for_bit():
    from vln_bevbert_tpu_torch.ops.dropout import dropout_ref

    g = torch.Generator().manual_seed(9)
    x = torch.randn(6, 5, 13, generator=g)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (6,), generator=g, dtype=torch.int32)
    for rate in (0.1, 0.4):
        assert torch.equal(rdrop.seeded_dropout(x, seeds, rate), dropout_ref(x, seeds, rate))
