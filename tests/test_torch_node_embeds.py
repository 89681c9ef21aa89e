"""The rollout's node contraction (``GMapNavAgent._policy_node_embeds``)
against the dense formula: every stored step's panorama tokens copied into
a zero-filled (B, T * V, D) store, contracted with ``gmap_agg`` by
``np.einsum``. The rows of ``gmap_agg`` are built as ``_nav_gmap_variable``
builds them: a visited node is the mean of its step's valid views (and
objects), an unvisited one the mean of its sightings."""

import numpy as np
import pytest

from vln_bevbert_tpu_torch.configs import FinetuneConfig, ModelConfig, ShapeConfig
from vln_bevbert_tpu_torch.nav.agent import GMapNavAgent

B, N, T, D = 4, 24, 15, 64


def make_agent(objects: bool) -> GMapNavAgent:
    model = ModelConfig(
        vocab_size=128, hidden_size=D, num_attention_heads=2, intermediate_size=64,
        num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
        obj_feat_size=16 if objects else 0, bev_grid_feat_size=12, bev_dim=5,
        bev_res=1.5, dtype="float32",
    )
    shapes = ShapeConfig(max_txt_len=16, max_pano_len=44, max_gmap_len=N, max_local_len=8,
                         max_objects=20, num_views=4, grid_hw=4, max_pc_steps=4)
    cfg = FinetuneConfig(model=model, shapes=shapes, batch_size=B, max_action_len=T)
    return GMapNavAgent(cfg, env=None, device="cpu")


def stored_steps(agent, steps, rng):
    """A pano store of ``steps`` steps whose rows differ in their view and
    object counts, and a ``gmap_agg`` over it as the rollout writes it."""
    sh, V = agent.cfg.shapes, agent.num_pano_slots
    store = {"view_lens": {}, "obj_lens": {}, "embeds": {}}
    for t in range(steps):
        store["view_lens"][t] = rng.integers(1, 37, B).astype(np.int32)
        if agent.with_objects:
            store["obj_lens"][t] = rng.integers(0, sh.max_objects + 1, B).astype(np.int32)
        store["embeds"][t] = rng.standard_normal((B, V, D)).astype(np.float32)
    agg = np.zeros((B, N, T * V), np.float32)
    for i in range(B):
        for node in range(1, rng.integers(N // 2, N + 1)):
            if node <= steps:  # visited at step node - 1
                t = node - 1
                vl = int(store["view_lens"][t][i])
                ol = int(store["obj_lens"][t][i]) if agent.with_objects else 0
                agg[i, node, t * V : t * V + vl] += 1.0 / (vl + ol)
                base = t * V + sh.max_pano_len
                agg[i, node, base : base + ol] += 1.0 / (vl + ol)
            else:
                seen = rng.integers(1, 4)
                for _ in range(seen):
                    t = rng.integers(steps)
                    slot = rng.integers(int(store["view_lens"][t][i]))
                    agg[i, node, t * V + slot] += 1.0 / seen
    return agg, store


def dense(agg, store, V):
    tokens = np.zeros((B, T * V, D), np.float32)
    for t, emb in store["embeds"].items():
        tokens[:, t * V : t * V + emb.shape[1]] = emb
    return np.einsum("bnm,bmd->bnd", agg, tokens)


@pytest.fixture(scope="module", params=[False, True], ids=["views", "objects"])
def agent(request):
    return make_agent(request.param)


@pytest.mark.parametrize("steps", [1, 8, T])
def test_the_node_contraction_equals_the_dense_einsum(agent, steps):
    V = agent.num_pano_slots
    assert V == (64 if agent.with_objects else 44)
    agg, store = stored_steps(agent, steps, np.random.default_rng(steps))
    before = agent.counters()["node_tokens"]
    out = agent._policy_node_embeds(agg, store, B)
    ref = dense(agg, store, V)
    assert out.shape == (B, N, D) and out.dtype == np.float32 and out.flags.c_contiguous
    assert np.abs(ref).max() > 0
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    # nodes past a row's map stay exactly zero
    assert np.array_equal(out[~agg.any(2)], ref[~agg.any(2)])
    assert agent.counters()["node_tokens"] - before == steps * V
