"""The port's precompute pipeline (``vln_bevbert_tpu_torch/precompute/``)
against the JAX package's, on the CPU: the HDF5 products on the same
``SyntheticImageSource`` frames (two viewpoints, 32x32 frames, a 2x2 grid).

- ``build_feature_files`` with ``RandomProjectionEncoder`` (host numpy):
  every dataset of the four stores, the raw-frame dumps and the packs'
  rows bitwise equal;
- with the towers (a small CLIP, hidden 64, as ``DeviceClipEncoder`` and
  ``JaxClipEncoder`` over the same parameters): view features at rtol 1e-4,
  atol 1e-5, grids as stored in float16 within one float16 ulp (rtol
  2**-10), depth and semantics bitwise;
- ``dump_raw_view_images``, rgb (BGR) and depth: datasets and attributes
  bitwise;
- ``dump_depth_features`` on the full-width DDPPO tower with the JAX
  pipeline's default random parameters (``PRNGKey(0)``): pooled (36, 2048)
  features at rtol 1e-4, atol 1e-5, attributes equal; the port's seeded
  default parameters give the same file twice.
"""

import importlib

import h5py
import jax
import numpy as np
import pytest

from test_torch_clip import jax_tower_params
from vln_bevbert_tpu.models import depth_encoder as jax_de
from vln_bevbert_tpu.precompute.pipeline import JaxClipEncoder
from vln_bevbert_tpu_torch.convert import flax_to_state_dict
from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

PKGS = ("vln_bevbert_tpu", "vln_bevbert_tpu_torch")
VIEWPOINTS = {"scanA": ["v1", "v2"]}
HW, GRID = 32, 2
RTOL, ATOL = 1e-4, 1e-5


def pipeline(pkg):
    return importlib.import_module(f"{pkg}.precompute.pipeline")


def source(pkg):
    return pipeline(pkg).SyntheticImageSource(VIEWPOINTS, image_hw=HW, grid_hw=GRID, seed=3)


def read_all(path):
    """{key: (array, attrs)} of an HDF5 file."""
    with h5py.File(path, "r") as f:
        return {k: (f[k][...], dict(f[k].attrs)) for k in f}


def assert_files_equal(a, b):
    fa, fb = read_all(a), read_all(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k][0].dtype == fb[k][0].dtype, k
        np.testing.assert_array_equal(fa[k][0], fb[k][0], err_msg=k)
        assert fa[k][1] == fb[k][1], k


def test_host_encoder_products_are_bitwise_jaxs(tmp_path):
    paths = {}
    for pkg in PKGS:
        enc = pipeline(pkg).RandomProjectionEncoder(grid_hw=GRID, seed=5)
        paths[pkg] = pipeline(pkg).build_feature_files(
            source(pkg), enc, str(tmp_path / pkg), progress_every=0, save_raw_images=True)
    assert sorted(paths[PKGS[0]]) == sorted(paths[PKGS[1]])
    for key, path in paths[PKGS[0]].items():
        assert_files_equal(path, paths[PKGS[1]][key])
    for key in ("img_ft", "depth", "sem"):  # the grids' rows are too big to pack
        rows = [np.load(paths[pkg][key] + ".pack.npy") for pkg in PKGS]
        np.testing.assert_array_equal(rows[0], rows[1], err_msg=key)
        assert rows[0].dtype == np.dtype({"img_ft": np.float32, "depth": np.float32,
                                          "sem": np.uint8}[key])

    for kind in ("rgb", "depth"):
        out = [pipeline(pkg).dump_raw_view_images(source(pkg), str(tmp_path / pkg / f"{kind}.h5"),
                                                  img_type=kind, progress_every=0)
               for pkg in PKGS]
        assert_files_equal(*out)
    with pytest.raises(ValueError, match="rgb|depth"):
        pipeline(PKGS[1]).dump_raw_view_images(source(PKGS[1]), str(tmp_path / "x.h5"), "sem")


def test_tower_products_match_jax(tmp_path):
    _, params = jax_tower_params(image=HW, seed=4, hidden_size=64, num_heads=1)
    encoders = {PKGS[0]: JaxClipEncoder(params, grid_hw=GRID, hidden_size=64,
                                        intermediate_size=64, num_layers=2, num_heads=1),
                PKGS[1]: DeviceClipEncoder(flax_to_state_dict(params), grid_hw=GRID,
                                           device="cpu")}
    paths = {pkg: pipeline(pkg).build_feature_files(source(pkg), encoders[pkg],
                                                    str(tmp_path / pkg), progress_every=0)
             for pkg in PKGS}
    ref, got = (read_all(paths[pkg]["img_ft"]) for pkg in PKGS)
    for k in ref:
        assert got[k][0].shape == (36, 64)
        np.testing.assert_allclose(got[k][0], ref[k][0], rtol=RTOL, atol=ATOL, err_msg=k)
    ref, got = (read_all(paths[pkg]["rgb"]) for pkg in PKGS)
    for k in ref:
        assert got[k][0].dtype == np.float16 and got[k][0].shape == (12, GRID * GRID, 64)
        np.testing.assert_allclose(got[k][0].astype(np.float32), ref[k][0].astype(np.float32),
                                   rtol=2 ** -10, atol=ATOL, err_msg=k)
    for key in ("depth", "sem"):
        assert_files_equal(paths[PKGS[0]][key], paths[PKGS[1]][key])


def test_depth_features_match_jax(tmp_path):
    raw = {pkg: pipeline(pkg).dump_raw_view_images(source(pkg), str(tmp_path / pkg / "d.h5"),
                                                   img_type="depth", progress_every=0)
           for pkg in PKGS}
    # the JAX pipeline's default parameters: the full-width tower at PRNGKey(0)
    tree = jax.jit(jax_de.DdppoDepthEncoder().init)(
        jax.random.PRNGKey(0), np.zeros((36, HW, HW, 1), np.float32))["params"]
    ref_file = pipeline(PKGS[0]).dump_depth_features(raw[PKGS[0]], str(tmp_path / "ref.h5"),
                                                     params=tree, progress_every=0)
    got_file = pipeline(PKGS[1]).dump_depth_features(
        raw[PKGS[1]], str(tmp_path / "got.h5"),
        params=flax_to_state_dict(jax.tree.map(np.asarray, tree)), progress_every=0,
        device="cpu")
    ref, got = read_all(ref_file), read_all(got_file)
    assert ref.keys() == got.keys() and len(got) == 2
    for k in ref:
        assert got[k][0].shape == (36, 2048) and got[k][0].dtype == np.float32
        np.testing.assert_allclose(got[k][0], ref[k][0], rtol=RTOL, atol=ATOL, err_msg=k)
        assert got[k][1] == ref[k][1]
    seeded = [pipeline(PKGS[1]).dump_depth_features(raw[PKGS[1]], str(tmp_path / f"s{i}.h5"),
                                                    progress_every=0, device="cpu")
              for i in range(2)]
    assert_files_equal(*seeded)
