"""Parity of the port's ops (vln_bevbert_tpu_torch.ops) with the JAX package.

The same numpy inputs go through the JAX function and its port. The Pallas
splat runs as the JAX tests run it on the CPU (interpret mode). Tolerances:
float32 algorithm parity at atol=rtol=1e-4; sums of a bf16 payload are
exact products accumulated in float32 in another order, inside the same
bound. Integer-valued results (counts, occupancy, cells) must be equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bev import loop_lift_splat, make_inputs
from vln_bevbert_tpu.geometry import se3_from_xyzhe
from vln_bevbert_tpu.nav.agent import gather_and_splat as jax_gather_and_splat
from vln_bevbert_tpu.ops import masking as jmask
from vln_bevbert_tpu.ops.bev import BevProjector as JaxProjector
from vln_bevbert_tpu.ops.pallas_splat import splat_sums as jax_splat_sums
from vln_bevbert_tpu_torch import _build
from vln_bevbert_tpu_torch.nav.agent import gather_and_splat
from vln_bevbert_tpu_torch.ops import masking as tmask
from vln_bevbert_tpu_torch.ops.bev import BevProjector
from vln_bevbert_tpu_torch.ops.dropout import Dropout, set_dropout_generator
from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_plain, splat_sums_ref
from vln_bevbert_tpu_torch.utils.rng import make_generator

TOL = dict(atol=1e-4, rtol=1e-4)
def T(x):
    return torch.from_numpy(np.array(x))


def bf16_payload(rng, shape):
    """A payload whose values are exactly representable in bfloat16."""
    x = rng.normal(size=shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------------ masking
def test_masking_matches_jax(rng):
    mask = rng.uniform(size=(3, 7)) < 0.5
    bias = tmask.attn_bias(T(mask))
    assert bias.dtype == torch.float32 and bias.shape == (3, 1, 1, 7)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jmask.attn_bias(mask)))
    assert tmask.NEG_INF == jmask.NEG_INF == -10000.0
    x = rng.normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tmask.masked_fill_neg(T(x), T(mask)).numpy(),
        np.asarray(jmask.masked_fill_neg(x, mask)),
    )


# -------------------------------------------------------------------- splat
@pytest.mark.parametrize("b,n,c,d", [(2, 64, 9, 13), (1, 300, 25, 70), (3, 50, 121, 5)])
def test_splat_sums_ref_matches_pallas_and_einsum(rng, b, n, c, d):
    cell = rng.integers(-1, c, size=(b, n)).astype(np.int32)  # -1: invalid
    payload = bf16_payload(rng, (b, n, d))
    ours = splat_sums_ref(T(cell), T(payload).to(torch.bfloat16), c).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jax_splat_sums(cell, payload, c)), **TOL
    )
    one_hot = (cell[:, :, None] == np.arange(c)).astype(np.float32)
    np.testing.assert_allclose(ours, np.einsum("bnc,bnd->bcd", one_hot, payload), **TOL)


def test_splat_sums_edge_cases(rng):
    b, n, c, d = 3, 40, 9, 6
    payload = bf16_payload(rng, (b, n, d))
    cell = rng.integers(0, c, size=(b, n)).astype(np.int32)
    cell[0] = -1                    # an all-invalid row
    cell[1, ::3] = c + 4            # cells out of range match no cell
    out = splat_sums_ref(T(cell), T(payload).to(torch.bfloat16), c).numpy()
    np.testing.assert_array_equal(out[0], 0.0)
    np.testing.assert_allclose(out, np.asarray(jax_splat_sums(cell, payload, c)), **TOL)
    np.testing.assert_allclose(
        out[1].sum(0), payload[1][cell[1] < c].sum(0), **TOL
    )


def test_splat_sums_wrapper_routes_by_device(rng):
    cell = T(rng.integers(0, 4, size=(1, 8)).astype(np.int32))
    feats = torch.ones(1, 8, 8, dtype=torch.bfloat16)
    before = _build.launches("splat")
    out = splat_sums(cell, feats, 4)           # CPU: the plain version
    assert _build.launches("splat") == before   # ... which is no kernel launch
    torch.testing.assert_close(out, splat_sums_plain(cell, feats, 4))
    with pytest.raises(ValueError, match="CUDA"):
        splat_sums(cell.to("meta"), feats.to("meta"), 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("by_step,num_sem", [(False, 0), (False, 5), (True, 0), (True, 3)])
def test_fused_splat_plain_equals_the_payload_splat(rng, dtype, by_step, num_sem):
    """The kernel's plain version (rows read through ``step_sel``, the
    one-hot and the count column added) equals ``splat_sums_ref`` of the
    concatenated bf16 payload the parent built: counts exactly, sums to
    float32 order. A step_sel that repeats a step reads its rows twice."""
    B, T_, P, D, S, C = 2, 4, 6, 16, 3, 9
    if by_step:
        store = T(rng.normal(size=(B, T_, P, D)).astype(np.float32)).to(dtype)
        step_sel = T(np.array([[2, 0, 2], [3, 1, 0]], np.int32))
        rows = store[torch.arange(B)[:, None], step_sel.long()].reshape(B, S * P, D)
    else:
        store = T(rng.normal(size=(B, S * P, D)).astype(np.float32)).to(dtype)
        step_sel, rows = None, store
    cell = T(rng.integers(-1, C + 2, size=(B, S * P)).astype(np.int32))  # -1, out of range
    cell[1] = -1                                                          # an all-invalid row
    sem = T(rng.integers(0, max(num_sem, 1), size=(B, S * P)).astype(np.int32)) if num_sem else None
    cols = [rows.to(torch.bfloat16)]
    if num_sem:
        cols.append(torch.nn.functional.one_hot(sem.long(), num_sem).to(torch.bfloat16))
    cols.append(torch.ones(B, S * P, 1, dtype=torch.bfloat16))
    want = splat_sums_ref(cell, torch.cat(cols, -1), C)
    got = splat_sums(cell, store, C, step_sel=step_sel, sem_labels=sem, num_sem=num_sem)
    assert got.shape == (B, C, D + num_sem + 1) and got.dtype == torch.float32
    torch.testing.assert_close(got[..., D:], want[..., D:], atol=0, rtol=0)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()
    assert torch.equal(got[..., -1].sum(-1), ((cell >= 0) & (cell < C)).sum(-1).float())


# ---------------------------------------------------------------------- bev
def _projectors(num_sem, map_dim=5, map_res=1.0, V=3, HW=4, use_pallas=False):
    kw = dict(vfov=math.radians(90.0), grid_hw=HW, num_views=V, map_dim=map_dim,
              map_res=map_res, z_clip=0.5, num_sem=num_sem)
    return JaxProjector(use_pallas=use_pallas, **kw), BevProjector(**kw)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bev_projector_matches_jax(rng, use_pallas):
    B, V, HW, num_sem, C = 2, 3, 4, 7, 16
    depths, T_c2w, T_w2c, S_w2c, feats, sem = make_inputs(rng, B, V, HW, num_sem, C)
    T_c2w, T_w2c = T_c2w.astype(np.float32), T_w2c.astype(np.float32)
    jp, tp = _projectors(num_sem, V=V, HW=HW, use_pallas=use_pallas)

    pts_j, nd_j = jp.lift(depths, T_c2w)
    pts_t, nd_t = tp.lift(T(depths), T(T_c2w))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), **TOL)
    np.testing.assert_array_equal(nd_t.numpy(), np.asarray(nd_j))

    cell_j, ok_j = jp.ego_cells(np.asarray(pts_j), T_w2c, S_w2c)
    cell_t, ok_t = tp.ego_cells(T(np.asarray(pts_j)), T(T_w2c), T(S_w2c))
    np.testing.assert_array_equal(cell_t.numpy(), np.asarray(cell_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))

    valid = np.asarray(ok_j) & ~np.asarray(nd_j)
    out_j = jp.splat(np.asarray(cell_j), valid, feats, sem)
    out_t = tp.splat(cell_t, T(valid), T(feats), T(sem))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), **TOL)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    full_j = jp.lift_splat(depths, T_c2w, T_w2c, S_w2c, feats, sem)
    full_t = tp.lift_splat(T(depths), T(T_c2w), T(T_w2c), T(S_w2c), T(feats), T(sem))
    np.testing.assert_allclose(full_t[0].numpy(), np.asarray(full_j[0]), **TOL)
    for a, b in zip(full_t[1:], full_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # the loop golden of tests/test_bev.py (bf16 payload: ~1e-2 absolute)
    exp = loop_lift_splat(depths, T_c2w, T_w2c, S_w2c, feats, sem,
                          jp.vfov, jp.map_dim, jp.map_res, jp.z_clip, num_sem)
    np.testing.assert_allclose(full_t[0].numpy(), exp[0], atol=2e-2)
    for a, b in zip(full_t[1:], exp[1:]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bev_edge_cases_match_jax(rng):
    B, V, HW, num_sem, C = 2, 3, 4, 7, 16
    depths, T_c2w, T_w2c, S_w2c, feats, sem = make_inputs(rng, B, V, HW, num_sem, C)
    depths[0] = 0.0                                   # zero depth everywhere
    jp, tp = _projectors(num_sem, V=V, HW=HW)
    full_j = jp.lift_splat(depths, T_c2w, T_w2c, S_w2c, feats, sem)
    full_t = tp.lift_splat(T(depths), T(T_c2w.astype(np.float32)),
                           T(T_w2c.astype(np.float32)), T(S_w2c), T(feats), T(sem))
    assert not full_t[1][0].any()                      # nothing lands in row 0
    np.testing.assert_array_equal(full_t[0][0].numpy(), 0.0)
    np.testing.assert_allclose(full_t[0].numpy(), np.asarray(full_j[0]), **TOL)
    # an all-invalid row and the no-semantics payload
    cell = rng.integers(0, 25, size=(B, V * HW * HW)).astype(np.int32)
    valid = np.ones((B, V * HW * HW), bool)
    valid[1] = False
    out_j = jp.splat(cell, valid, feats)
    out_t = tp.splat(T(cell), T(valid), T(feats))
    assert out_t[2] is None and out_t[3] is None
    assert not out_t[1][1].any()
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), **TOL)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))


def test_gather_and_splat_matches_jax(rng):
    B, T_, P, D, S = 2, 5, 48, 12, 3
    jp, tp = _projectors(0, map_dim=5, map_res=1.5, V=3, HW=4)
    pc = rng.normal(scale=2.0, size=(B, T_, P, 3)).astype(np.float32)
    valid = rng.uniform(size=(B, T_, P)) < 0.8
    feats = bf16_payload(rng, (B, T_, P, D))
    step_sel = rng.integers(0, T_, size=(B, S)).astype(np.int32)
    step_ok = np.array([[True, True, False], [True, False, False]])
    heading = rng.uniform(-math.pi, math.pi, size=B)
    T_w2c = se3_from_xyzhe(np.stack(
        [np.zeros(B), np.zeros(B), np.zeros(B), heading, np.zeros(B)], -1
    )).astype(np.float32)
    S_w2c = rng.normal(scale=0.5, size=(B, 3)).astype(np.float32)
    ours = gather_and_splat(tp, T(pc), T(valid), T(feats).to(torch.bfloat16),
                            T(step_sel), T(step_ok), T(T_w2c), T(S_w2c))
    ref = jax_gather_and_splat(jp, pc, valid, jnp.asarray(feats, jnp.bfloat16),
                               step_sel, step_ok, T_w2c, S_w2c)
    assert ours.shape == (B, 25, D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------------ dropout
def test_dropout_eval_identity_and_train_distribution():
    drop = Dropout(0.25, site="attn_probs")
    x = torch.ones(200, 500)
    assert drop.eval()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    set_dropout_generator(drop, make_generator(3))
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    set_dropout_generator(drop, make_generator(3))
    torch.testing.assert_close(drop(x), y)            # same seed, same mask


def test_make_generator_is_seeded():
    a = torch.rand(5, generator=make_generator(11))
    b = torch.rand(5, generator=make_generator(11))
    c = torch.rand(5, generator=make_generator(12))
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
