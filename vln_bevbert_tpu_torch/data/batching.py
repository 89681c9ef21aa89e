"""Static-shape batch assembly (the TPU collate).

Replaces the reference's per-task dynamic-padding collates
(reference pretrain_src/data/tasks.py) with one packer that emits the
fixed-bucket key contract of models/glocal.py, plus the two host-precomputed
device tensors that replace per-sample Python loops:

- ``gmap_agg``  (N, T*P): node-feature aggregation weights
  (ref _aggregate_gmap_features, pretrain_src/model/vilmodel.py:632-666);
- ``fuse_map``  (N, K): SAP local->global logit fusion
  (ref forward_sap backtracking loop, pretrain_cmt.py:339-356).

MLM masking (BERT 80/10/10, ref tasks.py:14-55) happens here, emitting
fixed-width gathered positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs import ModelConfig, ShapeConfig
from ..geometry import bev_polar_pos
from .pathdata import PathExample


def mask_tokens(
    tokens: np.ndarray,
    rng: np.random.Generator,
    vocab_range: Tuple[int, int],
    mask_token: int,
    prob: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    """BERT 80/10/10 masking; guarantees at least one masked position
    (ref random_word, tasks.py:14-55). Returns (masked_tokens, labels) with
    label -1 at unmasked positions."""
    tokens = np.asarray(tokens).copy()
    labels = np.full(len(tokens), -1, np.int64)
    r = rng.uniform(size=len(tokens))
    sel = r < prob
    if not sel.any():
        sel[int(rng.integers(len(tokens)))] = True
        r[sel] = 0.0
    labels[sel] = tokens[sel]
    u = r[sel] / prob
    replacement = np.where(
        u < 0.8,
        mask_token,
        np.where(
            u < 0.9,
            rng.integers(vocab_range[0], vocab_range[1], size=sel.sum()),
            tokens[sel],
        ),
    )
    tokens[sel] = replacement
    return tokens, labels


def build_gmap_agg(
    ex: PathExample, shapes: ShapeConfig, num_view_slots: int, num_slots: int,
    num_steps: Optional[int] = None, num_nodes: Optional[int] = None,
) -> np.ndarray:
    """(N, T*P) aggregation weights. Visited node: mean over its (last) visit
    step's valid tokens. Frontier node: mean over its candidate sightings."""
    P = num_slots
    N = num_nodes if num_nodes is not None else shapes.max_gmap_len
    T = num_steps if num_steps is not None else shapes.max_steps
    agg = np.zeros((N, T * P), np.float32)
    n_steps = min(len(ex.traj_vpids), T)
    last_visit = {}
    for t in range(n_steps):
        last_visit[ex.traj_vpids[t]] = t
    visited = set(last_visit)
    n_views = [min(len(v), num_view_slots) for v in ex.traj_view_fts]
    n_objs = [
        min(len(o), P - num_view_slots) if ex.traj_obj_fts is not None else 0
        for o in (ex.traj_obj_fts or [[]] * n_steps)
    ]
    for node, vp in enumerate(ex.gmap_vpids[:N]):
        if vp is None:
            continue
        if vp in visited:
            t = last_visit[vp]
            total = n_views[t] + n_objs[t]
            if total == 0:
                continue
            agg[node, t * P : t * P + n_views[t]] = 1.0 / total
            if n_objs[t]:
                agg[node, t * P + num_view_slots : t * P + num_view_slots + n_objs[t]] = 1.0 / total
        else:
            sightings = []
            for t in range(n_steps):
                for j, cand in enumerate(ex.traj_cand_vpids[t]):
                    if cand == vp and j < n_views[t]:
                        sightings.append((t, j))
            for t, j in sightings:
                agg[node, t * P + j] += 1.0 / len(sightings)
    return agg


def build_fuse_map(
    ex: PathExample, shapes: ShapeConfig, num_nodes: Optional[int] = None
) -> np.ndarray:
    """(N, K) 0/1 map: fused[n] = global[n] + sum_k map[n,k]*local[k]
    (semantics of the reference backtracking loop, pretrain_cmt.py:339-356)."""
    N = num_nodes if num_nodes is not None else shapes.max_gmap_len
    K = shapes.max_local_len
    fm = np.zeros((N, K), np.float32)
    fm[0, 0] = 1.0  # [stop]
    visited = {
        vp for vp, m in zip(ex.gmap_vpids, ex.gmap_visited_masks) if m and vp
    }
    last_cands = ex.traj_cand_vpids[-1][: K - 1]
    back_cols = [
        k + 1 for k, vp in enumerate(last_cands) if vp in visited
    ]
    fresh = {vp: k + 1 for k, vp in enumerate(last_cands) if vp not in visited}
    for n, vp in enumerate(ex.gmap_vpids[:N]):
        if n == 0 or vp is None or vp in visited:
            continue
        if vp in fresh:
            fm[n, fresh[vp]] = 1.0
        else:
            for k in back_cols:
                fm[n, k] = 1.0
    return fm


class HostArrays:
    """Where ``make_pretrain_batch`` puts its arrays: ``empty`` allocates one
    (numpy's heap), ``copy`` fills part of one from an example's array
    (numpy's copy). ``data.loader.PinnedArrays`` puts them in page-locked
    memory instead."""

    def empty(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        return np.empty(shape, dtype)

    def copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        dst[...] = src


def make_pretrain_batch(
    examples: Sequence[PathExample],
    task: str,
    shapes: ShapeConfig,
    model: ModelConfig,
    rng: np.random.Generator,
    vocab_range: Tuple[int, int] = (1996, 29611),
    mask_token: int = 103,
    mlm_prob: float = 0.15,
    bev_mrc_mask_prob: float = 0.15,
    obj_mrc_mask_prob: float = 0.15,
    arrays: HostArrays = HostArrays(),
) -> Dict[str, np.ndarray]:
    """The static-shape batch of ``task`` from ``examples``.

    ``arrays.empty`` allocates every output array and ``arrays.copy`` fills
    the grid features, most of the batch's bytes. The collate writes every
    element of what it allocates: arrays with padding are zero-filled first,
    the others are written whole, so the batch does not depend on what the
    memory held."""
    empty = arrays.empty

    def zeros(shape, dtype) -> np.ndarray:
        a = empty(shape, dtype)
        a.fill(0)
        return a

    B = len(examples)
    V = shapes.max_pano_len
    # Bucket the batch-dependent axes so compute follows the data instead of
    # the configured caps, with coarse steps to bound recompilation:
    #   trajectory: multiples of 4 (pano encoder cost is linear in T)
    #   text:       {64, 128, cap} (R2R instructions are ~30 tokens; the 200
    #               cap exists for RxR)
    #   global map: {half-cap, cap}
    t_needed = max(min(len(ex.traj_vpids), shapes.max_steps) for ex in examples)
    T = min(((t_needed + 3) // 4) * 4, shapes.max_steps)
    l_needed = max(len(ex.instr_encoding) for ex in examples)
    L = next(
        (b for b in (64, 128) if l_needed <= b < shapes.max_txt_len),
        shapes.max_txt_len,
    )
    n_needed = max(len(ex.gmap_vpids) for ex in examples)
    half_n = shapes.max_gmap_len // 2
    N_bucket = half_n if n_needed <= half_n else shapes.max_gmap_len
    with_objects = examples[0].traj_obj_fts is not None
    O = shapes.max_objects if with_objects else 0
    P = V + O
    N, K, M = N_bucket, shapes.max_local_len, shapes.max_masked_tokens
    C = model.num_bev_tokens
    A = model.angle_feat_size

    txt_ids = zeros((B, L), np.int32)
    txt_masks = zeros((B, L), bool)
    view_fts = zeros((B, T, V, model.image_feat_size), np.float32)
    loc_fts = zeros((B, T, P, A + 3), np.float32)
    nav_types = zeros((B, T, P), np.int32)
    view_lens = zeros((B, T), np.int32)
    last_step = empty((B,), np.int32)
    if with_objects:
        obj_fts = zeros((B, T, O, model.obj_feat_size), np.float32)
        obj_lens = zeros((B, T), np.int32)
    gmap_agg = empty((B, N, T * P), np.float32)
    gmap_step_ids = zeros((B, N), np.int32)
    gmap_visited = zeros((B, N), bool)
    gmap_masks = zeros((B, N), bool)
    gmap_pos_fts = zeros((B, N, A + 3), np.float32)
    gmap_pair_dists = zeros((B, N, N), np.float32)
    depths = empty((B, shapes.num_views, shapes.grid_hw, shapes.grid_hw), np.float32)
    # grid features ship in their source dtype (fp16 from disk — the device
    # casts to bf16 in the splat; fp32 from synthetic/dict stores)
    grid_fts = empty(
        (B, shapes.num_points, model.bev_grid_feat_size),
        examples[0].grid_fts.dtype,
    )
    sem_labels = empty((B, shapes.num_points), np.int32)
    T_c2w = empty((B, shapes.num_views, 4, 4), np.float32)
    T_w2c = empty((B, 4, 4), np.float32)
    S_w2c = empty((B, 3), np.float32)
    bev_nav_masks = zeros((B, C), bool)
    bev_cand_idxs = zeros((B, K), np.int32)
    local_masks = zeros((B, K), bool)
    fuse_map = empty((B, N, K), np.float32)
    bev_pos_fts = empty((B, C, A + 3 + 3), np.float32)
    glabels = empty((B,), np.int64)
    llabels = empty((B,), np.int64)
    polar = bev_polar_pos(model.bev_dim).reshape(C, 3)

    mlm = task == "mlm"
    if mlm:
        mlm_ids = zeros((B, L), np.int32)
        mlm_pos = zeros((B, M), np.int32)
        mlm_tgt = zeros((B, M), np.int32)
        mlm_valid = zeros((B, M), bool)

    for b, ex in enumerate(examples):
        ids = np.asarray(ex.instr_encoding)[:L]
        txt_ids[b, : len(ids)] = ids
        txt_masks[b, : len(ids)] = True
        if mlm:
            masked, labels = mask_tokens(
                ids, rng, vocab_range, mask_token, mlm_prob
            )
            mlm_ids[b, : len(ids)] = masked
            pos = np.nonzero(labels >= 0)[0][:M]
            mlm_pos[b, : len(pos)] = pos
            mlm_tgt[b, : len(pos)] = labels[pos]
            mlm_valid[b, : len(pos)] = True

        n_steps = min(len(ex.traj_vpids), T)
        last_step[b] = n_steps - 1
        for t in range(n_steps):
            vf = ex.traj_view_fts[t][:V]
            nv = len(vf)
            view_fts[b, t, :nv] = vf
            view_lens[b, t] = nv
            lf = ex.traj_loc_fts[t]
            nt = ex.traj_nav_types[t]
            n_raw_views = len(ex.traj_view_fts[t])
            loc_fts[b, t, :nv] = lf[:nv]
            nav_types[b, t, :nv] = nt[:nv]
            if with_objects:
                of = ex.traj_obj_fts[t][:O]
                no = len(of)
                if no:
                    obj_fts[b, t, :no] = of
                    loc_fts[b, t, V : V + no] = lf[n_raw_views : n_raw_views + no]
                    nav_types[b, t, V : V + no] = 2
                obj_lens[b, t] = no

        n_nodes = min(len(ex.gmap_vpids), N)
        gmap_masks[b, :n_nodes] = True
        gmap_step_ids[b, :n_nodes] = np.clip(
            ex.gmap_step_ids[:n_nodes], 0, model.max_action_steps - 1
        )
        gmap_visited[b, :n_nodes] = ex.gmap_visited_masks[:n_nodes]
        gmap_pos_fts[b, :n_nodes] = ex.gmap_pos_fts[:n_nodes]
        gmap_pair_dists[b, :n_nodes, :n_nodes] = ex.gmap_pair_dists[
            :n_nodes, :n_nodes
        ]
        gmap_agg[b] = build_gmap_agg(ex, shapes, V, P, num_steps=T, num_nodes=N)
        fuse_map[b] = build_fuse_map(ex, shapes, num_nodes=N)

        depths[b] = ex.depths
        arrays.copy(grid_fts[b], ex.grid_fts)
        sem_labels[b] = ex.sem_labels
        T_c2w[b] = ex.T_c2w
        T_w2c[b] = ex.T_w2c
        S_w2c[b] = ex.S_w2c
        cells = ex.bev_cand_cells[:K]
        bev_cand_idxs[b, : len(cells)] = cells
        local_masks[b, : len(cells)] = True
        bev_nav_masks[b, cells] = True
        bev_pos_fts[b, :, : A + 3] = ex.bev_gpos_fts[None, :]
        bev_pos_fts[b, :, A + 3 :] = polar

        glabels[b] = ex.global_act_label if ex.global_act_label < N else -100
        llabels[b] = ex.local_act_label if ex.local_act_label < K else -100

    bev_masks = empty((B, C), bool)
    bev_masks.fill(True)
    out = dict(
        txt_ids=txt_ids, txt_masks=txt_masks,
        traj_view_fts=view_fts, traj_loc_fts=loc_fts,
        traj_nav_types=nav_types, traj_view_lens=view_lens,
        traj_last_step=last_step,
        gmap_agg=gmap_agg, gmap_step_ids=gmap_step_ids,
        gmap_visited_masks=gmap_visited, gmap_masks=gmap_masks,
        gmap_pos_fts=gmap_pos_fts, gmap_pair_dists=gmap_pair_dists,
        depths=depths, grid_fts=grid_fts, sem_labels=sem_labels,
        T_c2w=T_c2w, T_w2c=T_w2c, S_w2c=S_w2c,
        bev_nav_masks=bev_nav_masks, bev_cand_idxs=bev_cand_idxs,
        local_masks=local_masks, fuse_map=fuse_map,
        bev_masks=bev_masks, bev_pos_fts=bev_pos_fts,
        global_act_labels=glabels, local_act_labels=llabels,
    )
    if with_objects:
        out.update(traj_obj_fts=obj_fts, traj_obj_lens=obj_lens)
        out["obj_labels"] = empty((B,), np.int64)
        out["obj_labels"][:] = [ex.obj_label for ex in examples]
        obj_probs = zeros((B, O, model.obj_prob_size), np.float32)
        obj_mrc = zeros((B, O), bool)
        for b, ex in enumerate(examples):
            if ex.obj_probs is not None and len(ex.obj_probs):
                n = min(len(ex.obj_probs), O)
                obj_probs[b, :n] = ex.obj_probs[:n]
            n_last = obj_lens[b, last_step[b]]
            if task == "mrc" and n_last > 0:
                m = rng.uniform(size=n_last) < obj_mrc_mask_prob
                if not m.any():
                    m[int(rng.integers(n_last))] = True
                obj_mrc[b, :n_last] = m
                # zero the masked object features at the final step
                # (ref _mask_img_feat, tasks.py:175-178,241-242)
                obj_fts[b, last_step[b], :n_last][m] = 0.0
        out["obj_probs"] = obj_probs
        out["obj_mrc_masks"] = obj_mrc
    if mlm:
        out.update(mlm_ids=mlm_ids, mlm_pos=mlm_pos, mlm_tgt=mlm_tgt,
                   mlm_valid=mlm_valid)
    if task in ("masksem", "sem"):
        mrc = empty((B, C), bool)
        np.less(rng.uniform(size=(B, C)), bev_mrc_mask_prob, out=mrc)
        for b in range(B):
            if not mrc[b].any():
                mrc[b, int(rng.integers(C))] = True
        out["bev_mrc_masks"] = mrc
    return out
