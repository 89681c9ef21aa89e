"""The port's teacher-recollection store (``nav/recollection.py``,
``utils/npz_store.py``) and the glocal CE DAgger loop against the JAX
package's, on the CPU at ``test_torch_ce``'s tiny configuration (every
dropout rate 0, the same perturbed parameters on both sides, the waypoint
head sharpened x100) and ``test_torch_nav``'s discrete world.

- ``agent_build_bundle`` through ``TeacherRecollectionStore.collect`` on a
  CE teacher rollout with the BEV branch and without it, and on a discrete
  rollout: equal to JAX's bundle key by key (BEV features at atol 1e-5),
  in RAM and spilled to disk (``bev_fts`` a float32 host array in both);
- ``train_epochs`` from the same bundles: losses at rtol 1e-5;
- save/load, spill eviction and a load that leaves the archive intact, as
  in JAX's ``test_recollection.py``;
- ``run_dagger`` for the ``bev`` policy at p 1.0: equal ``collected``,
  betas, store sizes and losses.
"""

import os

import jax
import numpy as np
import pytest

from test_torch_ce import make_pair
from test_torch_nav import CFG, make_env
from vln_bevbert_tpu.ce.dagger import run_dagger as jax_run_dagger
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.recollection import TeacherRecollectionStore as JaxStore
from vln_bevbert_tpu_torch.ce.dagger import run_dagger
from vln_bevbert_tpu_torch.convert import load_flax_params
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID, GMapNavAgent
from vln_bevbert_tpu_torch.nav.recollection import TeacherRecollectionStore


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """``pairs(kind)``: (JAX agent, port agent, JAX parameters) for 'ce_bev',
    'ce_etp' or 'discrete', made once; each call restores the parameters,
    a fresh optimizer, ``np_rng`` and the env's epoch."""
    made = {}

    def get(kind):
        if kind not in made:
            if kind == "discrete":
                root = tmp_path_factory.mktemp("discrete")
                jax_agent = JaxAgent(CFG, make_env(str(root)))
                jax_agent.init_params()
                ours = GMapNavAgent(CFG, make_env(str(root)), device="cpu")
            else:
                jax_agent, ours = make_pair(kind == "ce_bev")
            made[kind] = (jax_agent, ours, jax.tree.map(np.asarray, jax_agent.params))
        jax_agent, ours, params = made[kind]
        jax_agent.params = jax.tree.map(jax.numpy.asarray, params)
        jax_agent.opt_state = jax_agent.tx.init(jax_agent.params)
        load_flax_params(ours.model, params)
        ours._state = None
        for a in (jax_agent, ours):
            a.np_rng = np.random.default_rng(11)
            a.env.reset_epoch(**({"shuffle": False} if kind == "discrete" else {}))
        return jax_agent, ours

    return get


def assert_bundles_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, val in ref.items():
        mine = got[key]
        assert isinstance(mine, np.ndarray) and mine.dtype == val.dtype, key
        if key == "bev_fts":
            assert mine.dtype == np.float32 and mine.shape == val.shape
            np.testing.assert_allclose(mine, val, atol=1e-5, rtol=0)
            continue
        np.testing.assert_array_equal(mine, val, err_msg=key)


@pytest.mark.parametrize("kind", ["ce_bev", "ce_etp", "discrete"])
def test_bundle_matches_jax(pairs, kind, tmp_path):
    jax_agent, ours = pairs(kind)
    ref_store = JaxStore(jax_agent, capacity=8)
    assert ref_store.collect(1) == 1
    stores = {"ram": TeacherRecollectionStore(ours, capacity=8),
              "spill": TeacherRecollectionStore(ours, capacity=8, spill_dir=str(tmp_path))}
    for store in stores.values():
        ours.env.reset_epoch(**({"shuffle": False} if kind == "discrete" else {}))
        ours.np_rng = np.random.default_rng(11)
        assert store.collect(1) == 1
        assert_bundles_equal(store._get(0), ref_store.bundles[0])
    ref = ref_store.bundles[0]
    assert ref["targets"].shape[0] == ours.cfg.max_action_len
    assert (ref["targets"] != IGNORE_ID).any() and ("bev_fts" in ref) == (kind != "ce_etp")


def test_train_epochs_losses_match_jax(pairs):
    jax_agent, ours = pairs("ce_bev")
    ref_store, store = JaxStore(jax_agent), TeacherRecollectionStore(ours)
    assert ref_store.collect(2) == store.collect(2) == 2
    ref = ref_store.train_epochs(2, rng=np.random.default_rng(4))
    got = store.train_epochs(2, rng=np.random.default_rng(4))
    assert len(got) == 4 and all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_collect_train_save_load(pairs, tmp_path):
    _, ours = pairs("ce_etp")
    store = TeacherRecollectionStore(ours, capacity=8)
    assert store.collect(2) == 2 and len(store.bundles) == 2
    losses = store.train_epochs(2)
    assert len(losses) == 4 and all(np.isfinite(losses))
    store.save(str(tmp_path / "archive"))
    store2 = TeacherRecollectionStore(ours, capacity=8)
    assert store2.load(str(tmp_path / "archive")) == 2
    for key, val in store.bundles[0].items():
        np.testing.assert_array_equal(store2.bundles[0][key], val, err_msg=key)
    assert np.isfinite(store2.train_epochs(1)[0])


def test_spill_to_disk_evicts_and_resumes(pairs, tmp_path):
    _, ours = pairs("ce_bev")
    spill = str(tmp_path / "spill")
    store = TeacherRecollectionStore(ours, capacity=2, spill_dir=spill)
    assert store.collect(3) == 3 and len(store) == 2
    assert len([f for f in os.listdir(spill) if f.endswith(".npz")]) == 2
    assert store._get(0)["bev_fts"].dtype == np.float32
    losses = store.train_epochs(1)
    assert len(losses) == 2 and all(np.isfinite(losses))
    store2 = TeacherRecollectionStore(ours, capacity=2, spill_dir=spill)
    assert len(store2) == 2
    assert store2.collect(1, beta=0.5) == 1 and len(store2) == 2


def test_spill_load_preserves_archive(pairs, tmp_path):
    _, ours = pairs("ce_etp")
    store = TeacherRecollectionStore(ours, capacity=8)
    store.collect(3)
    arch = str(tmp_path / "arch")
    store.save(arch)
    assert len([f for f in os.listdir(arch) if f.endswith(".npz")]) == 3
    spilled = TeacherRecollectionStore(ours, capacity=2, spill_dir=str(tmp_path / "spill"))
    assert spilled.load(arch) == 2
    assert len([f for f in os.listdir(arch) if f.endswith(".npz")]) == 3
    assert spilled.collect(1) == 1 and len(spilled) == 2


def test_run_dagger_bev_matches_jax(pairs, tmp_path):
    jax_agent, ours = pairs("ce_bev")
    logs = {"jax": [], "ours": []}
    kw = dict(policy="bev", dagger_iters=2, update_size=2, p=1.0, epochs=1)
    ref = jax_run_dagger(jax_agent, str(tmp_path / "jax"), **kw,
                         log_fn=lambda it, m: logs["jax"].append(m))
    got = run_dagger(ours, str(tmp_path / "ours"), **kw,
                     log_fn=lambda it, m: logs["ours"].append(m))
    assert got["collected"] == ref["collected"] == [2, 2]
    for key in ("dagger/beta", "dagger/collected", "dagger/store_size"):
        assert [m[key] for m in logs["ours"]] == [m[key] for m in logs["jax"]], key
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert ours.np_rng.random() == jax_agent.np_rng.random()
