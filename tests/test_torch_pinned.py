"""The pretraining collate's allocator and the staging that reads its
batches, on the CPU: a graph's input signature is one for numpy arrays and
tensors, the collate writes every byte of what it allocates (so page-locked
blocks that the host allocator recycles give the same batch as fresh
zeroed memory), a block's padding keeps host tensors tensors, and
``GraphCache`` counts the host bytes it stages. The
card tests of ``tests/test_torch_cuda.py`` check the pinned batches
themselves, with ``small_loader`` from here."""

import tempfile

import numpy as np
import pytest
import torch

from vln_bevbert_tpu_torch.cli.finetune import synthetic_feature_dbs
from vln_bevbert_tpu_torch.configs import ModelConfig, PretrainConfig, ShapeConfig
from vln_bevbert_tpu_torch.data import loader as loader_mod
from vln_bevbert_tpu_torch.data.batching import HostArrays, make_pretrain_batch
from vln_bevbert_tpu_torch.data.loader import (
    PinnedArrays,
    PretrainLoader,
    make_synthetic_annotations,
    make_synthetic_object_world,
)
from vln_bevbert_tpu_torch.data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from vln_bevbert_tpu_torch.data.pathdata import TextPathData
from vln_bevbert_tpu_torch.nav.obj_env import ObjectDB
from vln_bevbert_tpu_torch.pretrain.trainer import pad_block
from vln_bevbert_tpu_torch.utils import graphs

#: every dtype the collate emits
DTYPES = (np.bool_, np.int32, np.int64, np.float16, np.float32)
OBJECT_TASKS = ("mlm", "mrc", "sap", "og", "masksem")


def small_config(with_objects: bool = False, batch_size: int = 4) -> PretrainConfig:
    """A small float32 pretraining configuration whose batches all take one
    text, trajectory and map bucket."""
    model = ModelConfig(vocab_size=400, hidden_size=64, num_attention_heads=2,
                        intermediate_size=128, num_l_layers=1, num_pano_layers=1,
                        num_x_layers=1, image_feat_size=32, bev_grid_feat_size=24, bev_dim=5,
                        num_sem_classes=7, dtype="float32", max_position_embeddings=64,
                        obj_feat_size=6 if with_objects else 0,
                        obj_prob_size=5 if with_objects else 0)
    shapes = ShapeConfig(max_txt_len=16, max_steps=3, max_pano_len=40, max_gmap_len=64,
                         max_local_len=8, max_objects=3 if with_objects else 0, num_views=2,
                         grid_hw=4, max_masked_tokens=4)
    tasks = OBJECT_TASKS if with_objects else ("mlm", "sap", "masksem")
    return PretrainConfig(model=model, shapes=shapes, tasks=tasks,
                          mix_ratio=(1,) * len(tasks), train_batch_size=batch_size)


def small_loader(cfg: PretrainConfig, seed: int = 3, **kwargs) -> PretrainLoader:
    """The port's loader over a synthetic world (4 scans x 20 viewpoints,
    grid features float16 as the stores hold them), with REVERIE-style
    objects where ``cfg`` has them."""
    m, s = cfg.model, cfg.shapes
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as conn:
        write_synthetic_connectivity(conn, rng, n_scans=4, n_nodes=20)
        nav = load_nav_graphs(conn)
    dbs = synthetic_feature_dbs(rng, {k: g.node_ids for k, g in nav.items()},
                                image_feat_size=m.image_feat_size,
                                grid_feat_size=m.bev_grid_feat_size, grid_hw=s.grid_hw,
                                num_views=s.num_views, num_sem=m.num_sem_classes)
    objects = {}
    if m.obj_feat_size:
        annos, obj_data, _ = make_synthetic_object_world(
            nav, rng, n_items=32, objects_per_vp=2, obj_feat_size=m.obj_feat_size,
            obj_prob_size=m.obj_prob_size)
        objects = dict(obj_db=ObjectDB(obj_data), obj_feat_size=m.obj_feat_size,
                       obj_prob_size=m.obj_prob_size, max_objects=s.max_objects,
                       dataset="reverie")
    else:
        annos = make_synthetic_annotations(nav, rng, n_items=32)
    db = TextPathData(annos, nav, build_scanvp_cands(nav), **dbs, **objects,
                      image_feat_size=m.image_feat_size, max_txt_len=s.max_txt_len,
                      bev_dim=m.bev_dim, bev_res=m.bev_res, num_views=s.num_views)
    return PretrainLoader(db, cfg, seed=seed, **kwargs)


class GarbageArrays(HostArrays):
    """Arrays whose every byte starts as 0xFF, filled with the copy that
    ``PinnedArrays`` uses (PyTorch's); it keeps what it handed out."""

    copy = PinnedArrays.copy

    def __init__(self):
        self.made = []

    def empty(self, shape, dtype) -> np.ndarray:
        a = np.empty(shape, dtype)
        a.view(np.uint8).fill(0xFF)
        self.made.append(a)
        return a


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_signature_is_one_for_numpy_arrays_and_tensors(dtype):
    """A graph's inputs are keyed by (key, shape, dtype name); a host batch
    of numpy arrays (the CPU's, a padded block's, the benchmark's resized
    warm-up batches) keys the graph that the same batch as CPU tensors (the
    loader's on a card) replays."""
    a = np.ones((2, 3), dtype)
    as_numpy = {"x": a, "y": np.zeros(4, np.float32)}
    as_tensors = {"x": torch.from_numpy(a), "y": torch.zeros(4)}
    mixed = {"x": torch.from_numpy(a), "y": np.zeros(4, np.float32)}
    assert graphs.signature(as_numpy) == graphs.signature(as_tensors) == graphs.signature(mixed)
    assert graphs.signature(as_numpy)[0] == ("x", (2, 3), np.dtype(dtype).name)


@pytest.mark.parametrize("task", OBJECT_TASKS)
def test_collate_writes_every_byte_it_allocates(task, monkeypatch):
    """``make_pretrain_batch`` over arrays whose bytes start as 0xFF, with
    the pinned path's copy, gives the numpy path's batch bit for bit, with
    objects: each array is zero-filled where it pads or written whole. Every
    array of the batch comes from the allocator (``PinnedArrays.tensors``
    finds its tensor)."""
    loader = small_loader(small_config(with_objects=True))
    monkeypatch.setattr(loader, "_pins", lambda: False)  # numpy on a card machine too
    _, want = loader.build_batch(5, task=task)
    garbage = GarbageArrays()

    def collate(*args, **kwargs):
        return make_pretrain_batch(*args, **{**kwargs, "arrays": garbage})

    monkeypatch.setattr(loader_mod, "make_pretrain_batch", collate)
    _, got = loader.build_batch(5, task=task)
    assert sorted(got) == sorted(want)
    assert "traj_obj_fts" in got and "obj_probs" in got
    made = {id(a) for a in garbage.made}
    for key, v in got.items():
        assert id(v) in made, key
        assert v.dtype == want[key].dtype and v.shape == want[key].shape, key
        assert v.tobytes() == want[key].tobytes(), key


def test_graph_cache_counts_the_host_bytes_it_stages():
    """``load`` adds every host array's bytes to ``staged_bytes`` and those
    already page-locked to ``staged_pinned_bytes`` (none on the CPU);
    ``counters()`` reports both."""
    cache = graphs.GraphCache()
    batch = {"a": np.arange(6, dtype=np.float16).reshape(2, 3), "b": np.ones(4, np.int64)}
    inputs = cache.inputs_for(batch, torch.device("cpu"))
    for _ in range(2):
        cache.load(inputs, batch)
    assert torch.equal(inputs["a"], torch.from_numpy(batch["a"]))
    counters = cache.counters()
    assert counters["staged_bytes"] == 2 * (6 * 2 + 4 * 8)
    assert counters["staged_pinned_bytes"] == 0


def test_to_device_leaves_host_data_on_the_cpu():
    """For the CPU ``to_device`` moves nothing: a tensor passes through and
    a numpy array becomes a tensor over the same memory."""
    from vln_bevbert_tpu_torch.utils.device import to_device

    cpu = torch.device("cpu")
    t = torch.arange(4)
    assert to_device(t, cpu) is t
    a = np.arange(6, dtype=np.float16)
    y = to_device(a, cpu)
    assert y.dtype == torch.float16 and np.shares_memory(y.numpy(), a)


def test_pad_block_pads_host_tensors_as_it_pads_numpy_arrays():
    """A block of CPU tensors is padded to the values and dtypes of the same
    block as numpy arrays, into tensors; a batch already at the block's
    shape keeps its tensor."""
    a = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "m": np.ones((2, 1), bool),
         "k": np.arange(2)}
    b = {"x": np.ones((2, 5), np.float32), "m": np.ones((3, 4), bool), "k": np.arange(2)}
    want = pad_block([a, b])
    block = [{k: torch.from_numpy(v) for k, v in d.items()} for d in (a, b)]
    got = pad_block(block)
    for g, w in zip(got, want):
        for key, v in w.items():
            assert isinstance(g[key], torch.Tensor), key
            assert g[key].numpy().dtype == v.dtype and np.array_equal(g[key].numpy(), v), key
    assert got[1]["x"] is block[1]["x"] and got[0]["k"] is block[0]["k"]
