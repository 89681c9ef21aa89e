"""The port's CE DAgger trainer for the PREVALENT policy
(``vln_bevbert_tpu_torch/ce/dagger.py``, ``models/legacy.py``) against the
JAX package's, on the CPU at ``test_torch_ce``'s tiny configuration (hidden
32, every dropout rate 0, 12 views, two episodes a batch; PREVALENT keeps
its 9 language and 4 cross-modal layers). Parameters are JAX's, perturbed by
N(0, 0.02), carried over by ``convert.load_flax_params``; the frozen
waypoint head is sharpened x100 so that its NMS peaks stand far apart.

- the forward (``language``: h_t and the sequence; ``visual``: h_t' and the
  action scores) at atol=rtol=1e-5, with the weights arriving as the JAX
  tree and as the reference's torch state dict (``prevalent_to_state_dict``
  against JAX's ``prevalent_to_tree``); masked slots stay below -100;
- one BPTT update on one stacked batch against JAX's ``_update``: the loss
  at rtol 1e-5, every gradient at rtol 1e-4 plus 1e-5 of the tensor's
  largest entry, the parameters and moments after clip and AdamW within
  ``test_torch_finetune``'s bounds for its bf16 first moment (entries whose
  gradient is rounding noise behind a softmax's shift invariance, the key
  biases, within 2 lr);
- ``collect`` at beta 1.0: equal stored episodes (float16 candidate arrays
  bitwise) and ``np_rng`` streams; ``iter_batches``: equal batches over the
  same shards; ``run_dagger`` at p 1.0: equal ``collected``, betas, losses;
- the CLI: ``--trainer dagger --policy prevalent|bev|etp --device cpu`` end
  to end, the ``dagger/*`` log, the shards, a ``ckpt_dagger`` that
  restores; ``etp`` builds no BEV branch; ``--pretrain_ckpt`` with
  ``prevalent`` is refused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_legacy import _random_torch_sd
from test_torch_ce import MODEL, WP_SHARPEN, ce_config, make_env
from test_torch_finetune import _adam_only, perturbed
from test_torch_train_step import _adam_state
import vln_bevbert_tpu.configs as jax_configs
from vln_bevbert_tpu.ce.dagger import DaggerEpisodeStore as JaxStore
from vln_bevbert_tpu.ce.dagger import PrevalentDaggerAgent as JaxPrevalent
from vln_bevbert_tpu.ce.dagger import run_dagger as jax_run_dagger
from vln_bevbert_tpu.ce.env import SyntheticContinuousEnv as JaxEnv
from vln_bevbert_tpu.ce.env import make_synthetic_ce_episodes as jax_episodes
from vln_bevbert_tpu.models.legacy import prevalent_to_tree
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.ce.dagger import (IGNORE_ID, DaggerEpisodeStore,
                                             PrevalentDaggerAgent, run_dagger)
from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
from vln_bevbert_tpu_torch.cli import ce_train as cli
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models.legacy import prevalent_to_state_dict

B, T, K = 2, 4, 6  # ce_config's batch and max_action_len; 5 candidates + stop


def dagger_config(pkg_configs):
    """``ce_config`` at fine-tuning's test step sizes (``test_torch_finetune``):
    Adam scales a gradient to a step of ~lr whatever its size, so entries
    whose gradients are rounding noise move by up to lr; at 5e-5 that stays
    inside the parameters' bound, and a decay of 0.1 is visible there."""
    return dataclasses.replace(ce_config(pkg_configs), learning_rate=5e-5, weight_decay=0.1)


@pytest.fixture(scope="module")
def pair():
    """(JAX agent, port agent, perturbed numpy params) on equal worlds. The
    parameters are the port's random ones as a flax tree, whose structure
    and shapes must be those of the JAX policy's ``init`` (traced, not
    compiled)."""
    jax_agent = JaxPrevalent(dagger_config(jax_configs), make_env(JaxEnv, jax_episodes), seed=0)
    ours = PrevalentDaggerAgent(dagger_config(configs),
                                make_env(SyntheticContinuousEnv, make_synthetic_ce_episodes),
                                seed=0, device="cpu")
    ours.init_params()
    params = perturbed(module_to_flax(ours.model))
    m = jax_agent.cfg.model
    dummy = {"txt_ids": np.zeros((B, 8), np.int32), "txt_masks": np.ones((B, 8), bool),
             "cand_rgb": np.zeros((B, K, m.image_feat_size), np.float32),
             "cand_depth": np.zeros((B, K, jax_agent.depth_dim), np.float32),
             "cand_dir": np.zeros((B, K, m.angle_feat_size), np.float32),
             "cand_masks": np.ones((B, K), bool)}
    want = jax.eval_shape(lambda r: jax_agent.model.init(r, "init", dummy),
                          jax.random.key(0))["params"]
    assert (jax.tree.structure(want) == jax.tree.structure(params) and jax.tree.leaves(
        jax.tree.map(lambda a, b: a.shape == b.shape, want, params)) == [True] * len(
        jax.tree.leaves(want)))
    wp_tree = perturbed(module_to_flax(ours.wp_model))
    wp_tree["cls_fc2"]["kernel"] *= WP_SHARPEN
    jax_agent.wp_params = jax.tree.map(jnp.asarray, wp_tree)
    ours.wp_model.load_state_dict(flax_to_state_dict(wp_tree))
    # a first stage that passes the gradients on unchanged and keeps them
    # as its state: one compiled update serves every test of the file
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    jax_agent.tx = optax.chain(keep, jax_agent.tx)
    return jax_agent, ours, params


def reset(pair, seed=0):
    """Both agents at ``params`` with a fresh optimizer, ``np_rng`` and env
    epoch."""
    jax_agent, ours, params = pair
    jax_agent.params = jax.tree.map(jnp.asarray, params)
    jax_agent.opt_state = jax_agent.tx.init(jax_agent.params)
    load_flax_params(ours.model, params)
    ours._state = None
    for a in (jax_agent, ours):
        a.np_rng = np.random.default_rng(seed)
        a.env.reset_epoch()
    return jax_agent, ours, params


def visual_inputs(rng, L):
    cfg = configs.ModelConfig(**MODEL)
    masks = np.ones((B, K), bool)
    masks[0, 3:] = False
    return {"cand_rgb": rng.normal(size=(B, K, cfg.image_feat_size)).astype(np.float32),
            "cand_depth": rng.normal(size=(B, K, 4)).astype(np.float32),
            "cand_dir": rng.normal(size=(B, K, cfg.angle_feat_size)).astype(np.float32),
            "cand_masks": masks, "txt_masks": np.arange(L)[None] < np.array([[L], [L - 3]])}


@pytest.mark.parametrize("weights", ["flax_tree", "reference_state_dict"])
def test_prevalent_forward_matches_jax(pair, weights):
    jax_agent, ours, params = pair
    load_flax_params(ours.model, params)
    if weights == "reference_state_dict":
        sd = _random_torch_sd(np.random.default_rng(7), jax_configs.ModelConfig(**MODEL), 9, 4)
        params = dict(params, vln_bert=prevalent_to_tree(sd))
        ours.model.vln_bert.load_state_dict(prevalent_to_state_dict(
            {"module.vln_bert." + k: torch.from_numpy(v) for k, v in sd.items()}))
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    L = 32
    vis = visual_inputs(rng, L)
    lang = {"txt_ids": rng.integers(0, 300, (B, L)).astype(np.int32),
            "txt_masks": vis.pop("txt_masks")}
    h_ref, seq_ref = jax_agent._fn("language")(jparams, lang)
    with torch.inference_mode():
        h, seq = ours.model("language", {k: torch.from_numpy(v) for k, v in lang.items()})
    for got, ref in ((h, h_ref), (seq, seq_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    lf = np.asarray(seq_ref).copy()
    lf[:, 0] = np.asarray(h_ref)
    batch = {"lang_embeds": lf, "txt_masks": lang["txt_masks"], **vis}
    h2_ref, scores_ref = jax_agent._fn("visual")(jparams, batch)
    with torch.inference_mode():
        h2, scores = ours.model("visual", {k: torch.from_numpy(v) for k, v in batch.items()})
    assert scores.dtype == torch.float32 and scores.shape == (B, K)
    for got, ref in ((h2, h2_ref), (scores, scores_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert float(scores[0, 3:].max()) < -100


def stacked_batch(seed=5):
    """One stacked batch as ``iter_batches`` yields it: float16 candidates,
    an oracle action in a live slot, the last step padding for every
    episode and one more for the second."""
    rng = np.random.default_rng(seed)
    cfg = configs.ModelConfig(**MODEL)
    masks = np.zeros((B, T, K), bool)
    action = np.full((B, T), IGNORE_ID, np.int32)
    for i in range(B):
        for t in range(T - 1 - i):
            n = int(rng.integers(2, K + 1))
            masks[i, t, :n] = True
            action[i, t] = rng.integers(0, n)
    ids = np.zeros((B, 32), np.int32)
    txt = np.zeros((B, 32), bool)
    for i, n in enumerate((19, 11)):
        ids[i, :n] = rng.integers(1, 300, n)
        txt[i, :n] = True
    return {"cand_rgb": rng.normal(size=(B, T, K, cfg.image_feat_size)).astype(np.float16),
            "cand_depth": rng.normal(size=(B, T, K, 4)).astype(np.float16),
            "cand_dir": rng.normal(size=(B, T, K, cfg.angle_feat_size)).astype(np.float16),
            "cand_masks": masks, "action": action, "txt_ids": ids, "txt_masks": txt}


def test_bptt_update_matches_jax(pair):
    jax_agent, ours, params = reset(pair)
    batch = stacked_batch()
    new_params, new_state, loss_ref = jax_agent._fn("update")(
        jax_agent.params, jax_agent.opt_state, batch, jax.random.split(jax_agent.rng)[1])
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, new_state[0]))

    state = ours.train_state
    with ours._training():
        loss = ours._bptt_loss(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    for name, p in ours.model.named_parameters():
        want = grads_ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    gnorm = state.apply_gradients()
    assert float(gnorm) > 0

    # parameters and moments after the clip and AdamW; the key half of a
    # fused kv/qkv bias has a gradient of rounding noise (the scores and
    # the action logits ignore a shift of a row), which Adam scales to
    # steps of up to lr either way
    params_ref = flax_to_state_dict(jax.tree.map(np.asarray, new_params))
    adam = _adam_state(_adam_only(new_state[1]))
    mu_ref = flax_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), adam.mu))
    nu_ref = flax_to_state_dict(jax.tree.map(np.asarray, adam.nu))
    hid, lr = MODEL["hidden_size"], ours.cfg.learning_rate
    for i, (name, p) in enumerate(ours.model.named_parameters()):
        got, ref = p.detach().numpy().copy(), params_ref[name].numpy().copy()
        mu, nu = state.tx.mu[i].float().numpy(), state.tx.nu[i].numpy()
        want_mu, want_nu = mu_ref[name].numpy(), nu_ref[name].numpy()
        noise = slice(hid, 2 * hid) if name.endswith("qkv.bias") else (
            slice(0, hid) if name.endswith("kv.bias") else slice(0, 0))
        np.testing.assert_allclose(got[noise], ref[noise], atol=2 * lr, rtol=0, err_msg=name)
        keep_ = np.ones(got.shape[0], bool)
        keep_[noise] = False
        np.testing.assert_allclose(got[keep_], ref[keep_], atol=4e-6, rtol=0, err_msg=name)
        np.testing.assert_allclose(mu[keep_], want_mu[keep_], rtol=2 ** -6,
                                   atol=2 ** -7 * float(np.abs(want_mu).max()), err_msg=name)
        np.testing.assert_allclose(nu[keep_], want_nu[keep_], rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want_nu).max()), err_msg=name)


def test_collect_and_iter_batches_match_jax(pair, tmp_path):
    jax_agent, ours, _ = reset(pair)
    stores = {"jax": JaxStore(str(tmp_path / "jax")), "ours": DaggerEpisodeStore(
        str(tmp_path / "ours"))}
    assert jax_agent.collect(stores["jax"], 2, beta=1.0) == 4
    assert ours.collect(stores["ours"], 2, beta=1.0) == 4
    assert len(stores["jax"]) == len(stores["ours"]) == 4
    for i in range(4):
        ref, got = stores["jax"].get(i), stores["ours"].get(i)
        assert sorted(got) == sorted(ref)
        for key, val in ref.items():
            assert got[key].dtype == val.dtype and got[key].shape == val.shape, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)
        assert ref["cand_rgb"].dtype == np.float16 and (ref["action"] != IGNORE_ID).any()
    assert ours.np_rng.random() == jax_agent.np_rng.random()

    # the port's store over JAX's shards batches as JAX's does
    port_view = DaggerEpisodeStore(str(tmp_path / "jax"))
    for size in (2, 3, 5):
        ref = list(stores["jax"].iter_batches(size, np.random.default_rng(size)))
        got = list(port_view.iter_batches(size, np.random.default_rng(size)))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for key in r:
                assert g[key].dtype == r[key].dtype, key
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)


def test_episode_store_stream_and_evict(tmp_path):
    store = DaggerEpisodeStore(str(tmp_path / "store"), capacity=3)
    for i in range(5):
        store.append({
            "instruction_enc": np.arange(4 + i, dtype=np.int32),
            "cand_rgb": np.full((2, 3, 4), i, np.float16),
            "cand_depth": np.zeros((2, 3, 2), np.float16),
            "cand_dir": np.zeros((2, 3, 4), np.float16),
            "cand_masks": np.ones((2, 3), bool),
            "action": np.array([i, -100], np.int32),
        })
    assert len(store) == 3
    assert {int(store.get(i)["action"][0]) for i in range(3)} == {2, 3, 4}
    batches = list(store.iter_batches(2))
    assert len(batches) == 2
    for b in batches:
        assert b["cand_rgb"].shape == (2, 2, 3, 4) and b["txt_ids"].shape[1] % 32 == 0
    assert len(DaggerEpisodeStore(str(tmp_path / "store"), capacity=3)) == 3


def test_run_dagger_matches_jax(pair, tmp_path):
    jax_agent, ours, _ = reset(pair)
    logs = {"jax": [], "ours": []}
    kw = dict(policy="prevalent", dagger_iters=2, update_size=2, p=1.0, epochs=1)
    ref = jax_run_dagger(jax_agent, str(tmp_path / "jax"), **kw,
                         log_fn=lambda it, m: logs["jax"].append(m))
    got = run_dagger(ours, str(tmp_path / "ours"), **kw,
                     log_fn=lambda it, m: logs["ours"].append(m))
    assert got["collected"] == ref["collected"] == [2, 2]
    assert got["betas"] == [m["dagger/beta"] for m in logs["jax"]] == [1.0, 1.0]
    assert [m["dagger/store_size"] for m in logs["ours"]] == [2, 4]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert ours.logs["loss"] and all(np.isfinite(ours.logs["grad_norm"]))
    assert ours.np_rng.random() == jax_agent.np_rng.random()


# ------------------------------------------------------------------ CLI
def cli_config(tmp_path):
    path = tmp_path / "ce_dagger.json"
    path.write_text(json.dumps({
        "model": {k: v for k, v in MODEL.items()},
        "shapes": {"max_txt_len": 32, "max_steps": 4, "max_pano_len": 16, "max_gmap_len": 12,
                   "max_local_len": 8, "max_objects": 0, "num_views": 12, "grid_hw": 4,
                   "max_pc_steps": 3},
        "batch_size": 2, "max_action_len": 3, "learning_rate": 1e-3}))
    return str(path)


@pytest.mark.parametrize("policy", ["prevalent", "bev", "etp"])
def test_dagger_cli_runs_and_its_checkpoint_restores(tmp_path, policy):
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--config", cli_config(tmp_path), "--trainer", "dagger",
            "--policy", policy, "--allow_random_frozen", "--n_episodes", "4",
            "--output_dir", str(out)]
    hist = cli.main(argv + ["--dagger_iters", "2", "--update_size", "2", "--dagger_epochs",
                            "1", "--store_capacity", "3"])
    assert hist["betas"] == [1.0, 0.75] and hist["collected"] == [2, 2]
    assert all(np.isfinite(hist["losses"]))
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["dagger/beta"] for m in logged] == [1.0, 0.75]
    assert {"dagger/collected", "dagger/loss", "dagger/store_size"} <= set(logged[-1])
    # a store of episodes (prevalent) or of one bundle per rollout (glocal)
    shards = [f for f in os.listdir(out / "store") if f.endswith(".npz")]
    assert len(shards) == logged[-1]["dagger/store_size"] == (3 if policy == "prevalent" else 2)

    _, trained = cli.build(cli.parse_args(argv))
    trained.restore_ckpt(str(out / "ckpt_dagger"))
    _, fresh = cli.build(cli.parse_args(argv + ["--seed", "1"]))
    saved = torch.load(out / "ckpt_dagger", weights_only=True)
    assert sorted(saved["params"]) == sorted(fresh.model.state_dict())
    fresh.restore_ckpt(str(out / "ckpt_dagger"))
    for (n, a), b in zip(trained.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    # one update over the first iteration's store, two over the second's
    assert fresh.train_state.state_dict()["count"] == 3
    names = set(fresh.model.state_dict())
    if policy == "prevalent":
        assert isinstance(fresh, PrevalentDaggerAgent)
        assert not any(n.startswith(("depth_fc", "trm_layer", "cls_fc")) for n in names)
    else:
        assert any("local" in n for n in names) == (policy == "bev")
        assert fresh.cfg.model.use_bev == (policy == "bev")


def test_dagger_cli_refuses_a_glocal_checkpoint_for_prevalent(tmp_path):
    with pytest.raises(SystemExit, match="prevalent_to_tree"):
        cli.main(["--device", "cpu", "--config", cli_config(tmp_path), "--trainer", "dagger",
                  "--policy", "prevalent", "--allow_random_frozen", "--pretrain_ckpt",
                  str(tmp_path / "ckpt_2"), "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("policy", ["prevalent", "bev", "etp"])
def test_dagger_config_matches_the_jax_cli(tmp_path, monkeypatch, policy):
    """The JAX CLI's config just before it builds its dagger agent (its batch
    is per chip there) equals the port's: ``etp`` is the topo-only model."""
    import vln_bevbert_tpu.ce.agent as jax_agent_mod
    import vln_bevbert_tpu.ce.dagger as jax_dagger_mod
    from vln_bevbert_tpu.cli import ce_train as jax_cli

    argv = ["--config", cli_config(tmp_path), "--allow_random_frozen", "--trainer", "dagger",
            "--policy", policy, "--output_dir", str(tmp_path)]
    seen = {}

    class Stop(RuntimeError):
        pass

    def capture(cfg, *a, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(jax_agent_mod, "CEAgent", capture)
    monkeypatch.setattr(jax_dagger_mod, "PrevalentDaggerAgent", capture)
    with pytest.raises(Stop):
        jax_cli.main(argv)
    ref = seen["cfg"]
    ref.batch_size //= jax.device_count()
    cfg = cli.make_config(cli.parse_args(argv + ["--device", "cpu"]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.model.use_bev == (policy != "etp")
