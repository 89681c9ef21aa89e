"""Single typed config tree covering pretrain / finetune / CE.

The reference uses three different config systems (argparse+JSON for pretrain,
flat argparse for finetune, YACS for CE — see the reference
pretrain_src/parser.py:135-146, map_nav_src/r2r/parser.py:5-150,
bevbert_ce/vlnce_baselines/config/default.py). We use one dataclass tree.

Defaults reproduce the reference R2R setup
(reference configs/r2r_model.json, configs/r2r_pretrain.json,
scripts/ft_r2r.bash:22-62).

TPU-specific additions: every dynamic shape in the reference (ragged pano
tokens, variable gmap length, variable text length) is padded to the static
buckets in :class:`ShapeConfig` so each proxy task compiles to exactly one XLA
program.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    """Architecture of the glocal cross-modal transformer (bert-base core).

    Field parity with reference configs/r2r_model.json.
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    num_l_layers: int = 9          # language encoder depth
    num_pano_layers: int = 2       # panorama (pre-norm) encoder depth
    num_x_layers: int = 4          # cross-modal depth (global and local branches each)

    image_feat_size: int = 512     # CLIP-ViT-B/16 pooled view feature
    angle_feat_size: int = 4       # (sin h, cos h, sin e, cos e)
    obj_feat_size: int = 0         # REVERIE/SOON: 768
    obj_prob_size: int = 0
    bev_grid_feat_size: int = 768  # CLIP 14x14 grid channel dim
    num_sem_classes: int = 40      # MP3D semantic categories

    max_action_steps: int = 100    # gmap step-id embedding table size
    update_lang_bert: bool = True
    use_lang2visn_attn: bool = True
    graph_sprels: bool = True      # distance-bias on global map attention
    glocal_fuse: bool = True       # dynamic global/local fusion weight
    use_depth_embedding: bool = False  # CE variant adds a 128->768 depth embed

    bev_dim: int = 21              # 21x21 (discrete) or 11x11 (CE)
    bev_res: float = 0.5           # metres per cell (1.0 for CE)
    use_bev: bool = True           # False = topo-only ETP architecture (no
                                   # local BEV branch at all; global logits
                                   # are the action scores — ref bevbert_ce/
                                   # vlnce_baselines/models/etp/vilmodel_cmt.py:721-751)
    feat_dropout: float = 0.4      # env-feature dropout

    lang_bert_name: str = "bert-base-uncased"  # or "xlm-roberta-base" (RxR)
    fix_lang_embedding: bool = False
    fix_pano_embedding: bool = False
    fix_local_branch: bool = False

    # compute
    dtype: str = "bfloat16"        # activation dtype under jit
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_bev_tokens(self) -> int:
        return self.bev_dim * self.bev_dim

    @property
    def bev_center(self) -> int:
        # [stop] cell: centre of the BEV grid
        # (ref pretrain_src/model/pretrain_cmt.py:325)
        return (self.bev_dim * self.bev_dim - 1) // 2


@dataclass
class ShapeConfig:
    """Static padding buckets. The reference pads dynamically per batch
    (pretrain_src/data/tasks.py collates); we pad to fixed maxima so each task
    is one compiled program. Masks carry the true lengths.
    """

    max_txt_len: int = 200         # configs/r2r_pretrain.json:7 max_txt_len
    max_steps: int = 21            # TRAIN_MAX_STEP=20 (+1 after truncation append)
    max_pano_len: int = 44         # <=36 views + duplicated cand views + objects
    max_gmap_len: int = 100        # 1 [stop] + visited + frontier nodes
    max_local_len: int = 20        # 1 [stop] + cands at current node (bev_cand_idxs)
    max_objects: int = 20          # REVERIE max_objects
    num_views: int = 12            # BEV source cameras (single elevation ring)
    grid_hw: int = 14              # 14x14 feature grid per view
    max_masked_tokens: int = 48    # MLM: fixed count of gathered positions
    max_pc_steps: int = 8          # nav: point-cloud gathers per BEV splat

    @property
    def num_points(self) -> int:
        return self.num_views * self.grid_hw * self.grid_hw  # 2352


@dataclass
class OptimConfig:
    """Pretrain optimisation (configs/r2r_pretrain.json:8-25)."""

    optim: str = "adamw"
    learning_rate: float = 5e-5
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.01
    grad_norm: float = 5.0
    warmup_steps: int = 10000
    num_train_steps: int = 100000
    lr_schedule: str = "linear"    # linear warmup + linear decay; or "noam"
    gradient_accumulation_steps: int = 1
    mu_dtype: str = "bfloat16"     # AdamW first-moment storage dtype. The
                                   # update is HBM-bandwidth-bound at B=16;
                                   # bf16 m halves its read+write traffic
                                   # (update math stays f32 — optax casts on
                                   # store). "float32" restores exact parity.
    nu_dtype: str = "float32"      # Second-moment storage dtype. bf16 cuts
                                   # another 6 bytes/param/step; with the
                                   # reference b2=0.98 the per-step increment
                                   # (~2% of nu) sits ~5x above bf16
                                   # resolution, and state_sr removes the
                                   # residual rounding bias (optim.py:
                                   # scale_by_adam_lp).
    state_sr: bool = False         # stochastic rounding on low-precision
                                   # moment stores (ignored when both moments
                                   # are float32). Default OFF: with b1=0.9 /
                                   # b2=0.98 each step's moment increment sits
                                   # well above bf16 resolution, so plain
                                   # round-to-nearest tracks (test_optim.py)
                                   # and SR's per-element random bits are pure
                                   # overhead on the bandwidth-bound update.
    grad_dtype: str = "float32"    # dtype the loss is differentiated in:
                                   # "bfloat16" makes the backward pass emit
                                   # bf16 grads (halving grad write + norm
                                   # read + optimizer read + DP psum bytes);
                                   # Adam math still runs f32 per-step
    fused_update: bool = False     # author clip+AdamW+decay+lr as ONE tree
                                   # pass (optim.py:fused_adamw_clip) instead
                                   # of optax's four chained transforms —
                                   # measured-equal math, targets the profiled
                                   # optimizer/elementwise tail; adamw-only



@dataclass
class PretrainConfig:
    """Proxy-task pretraining (tasks + mix ratios per scripts/pt_r2r.bash:4)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    tasks: Tuple[str, ...] = ("mlm", "sap", "masksem")
    mix_ratio: Tuple[float, ...] = (5.0, 5.0, 1.0)
    task_block_size: int = 8       # consecutive steps per task draw (see
                                   # data/loader.MetaLoader: executable-switch
                                   # cost; 1 = reference per-step sampling)
    train_batch_size: int = 16     # per chip
    val_batch_size: int = 16
    mlm_prob: float = 0.15
    mrc_mask_prob: float = 0.15
    bev_mrc_mask_prob: float = 0.15
    end_vp_pos_ratio: float = 0.2  # train_r2r.py task dataset construction
    sem_pred_token: str = "cattn"  # {cattn, sattn, embed}
    num_workers: int = 0           # forked batch-builder processes (0 = the
                                   # in-process prefetch thread); the role of
                                   # the reference DataLoader's n_workers
                                   # (pretrain_src/data/loader.py:149-156)
    block_unroll: int = 5          # scan-unroll inside block dispatches:
                                   # divides XLA's per-iteration carry copies
                                   # of the param+opt state (~15% of a
                                   # flagship step) at compile-time cost
    seed: int = 0
    valid_steps: int = 2500
    log_steps: int = 1000
    init_pretrained: str = "bert"  # {bert, lxmert, roberta, none}
    output_dir: str = "runs/pretrain"

    def task_distribution(self) -> List[float]:
        total = sum(self.mix_ratio)
        return [r / total for r in self.mix_ratio]


@dataclass
class FinetuneConfig:
    """Discrete-env DAgger fine-tuning (scripts/ft_r2r.bash:22-62)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)

    dataset: str = "r2r"           # {r2r, r4r, rxr, reverie, soon}
    batch_size: int = 4            # per chip
    learning_rate: float = 1e-5
    iters: int = 40000
    log_every: int = 2000
    ml_weight: float = 0.2
    feedback: str = "sample"       # student policy during DAgger; also
                                   # {teacher, argmax, expl_sample}
    expl_max_ratio: float = 0.6    # expl_sample: explore w.p. 1 - ratio
                                   # (ref parser.py --expl_max_ratio)
    act_visited_nodes: bool = False  # only the current node counts visited
                                   # (ref parser.py --act_visited_nodes)
    max_action_len: int = 15
    max_instr_len: int = 200
    expert_policy: str = "spl"     # {spl, ndtw}
    fusion: str = "avg"            # {avg(fused), global, local} — 'global'
                                   # is the topo-only (ETP-style) variant
    pc_order: int = 1              # hops of neighbour point clouds kept in BEV
    loss_nav_3: bool = True        # global+local+fused CE, as reference
    # CE eval-mode action execution (ref environments.py:437-479): 'control'
    # runs turn-discretized low-level motion, 'teleport' jumps between nodes
    ce_back_algo: str = "control"  # {control, teleport}
    ce_tryout: bool = True         # collision recovery sweep during control
    grad_norm: float = 5.0
    weight_decay: float = 0.01
    seed: int = 0
    output_dir: str = "runs/finetune"


def _update(obj: Any, overrides: Dict[str, Any]) -> Any:
    """Recursively apply a {dotted.key: value} / nested-dict override."""
    for key, value in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            _update(getattr(obj, head), {rest: value})
        elif dataclasses.is_dataclass(getattr(obj, key, None)) and isinstance(value, dict):
            _update(getattr(obj, key), value)
        else:
            if not hasattr(obj, key):
                raise KeyError(f"unknown config field: {type(obj).__name__}.{key}")
            setattr(obj, key, value)
    return obj


def load_config(cls, json_path: Optional[str] = None, **overrides):
    """Build a config with file defaults then keyword overrides, mirroring
    the reference's argparse+JSON precedence (pretrain_src/parser.py:135-146,
    CLI wins over file). Accepts JSON or YAML files (the reference's CE
    subsystem is YAML-configured, run_r2r/iter_train.yaml)."""
    cfg = cls()
    if json_path:
        with open(json_path) as f:
            if json_path.endswith((".yaml", ".yml")):
                import yaml

                _update(cfg, yaml.safe_load(f) or {})
            else:
                _update(cfg, json.load(f))
    if overrides:
        _update(cfg, overrides)
    return cfg
