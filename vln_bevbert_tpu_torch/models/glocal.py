"""The glocal (global topo-map + local BEV-map) cross-modal model and its
pretraining heads (port of ``vln_bevbert_tpu/models/glocal.py``).

Batch keys are the JAX package's static-shape contract (see its module
docstring), as torch tensors. A batch with ``traj_obj_fts``/``traj_obj_lens``
(REVERIE/SOON) appends object slots to every step's panorama, P = V + O: they
join the panorama encoder, the global-map node means (through ``gmap_agg``)
and, at the last step, the local branch's keys; ``mrc`` and ``og`` supervise
them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import ModelConfig
from ..ops.dropout import Dropout
from ..parallel import distributed
from ..ops.masking import attn_bias, masked_fill_neg
from .bert import BertEmbeddings, MlmHead, TwoLayerHead, _dt
from .encoders import GlobalMapEncoder, ImageEmbeddings, LanguageEncoder, LocalBEVEncoder

Batch = Dict[str, Any]


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, L, D), idx: (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[-1]))


class GlocalTextPathCMT(nn.Module):
    """Backbone: text encoder + pano encoder + global/local map encoders.
    ``lang2visn`` builds the map layers' language branch that
    ``forward_mlm`` runs."""

    def __init__(self, cfg: ModelConfig, device=None, lang2visn: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        self.lang_encoder = LanguageEncoder(cfg, device)
        self.img_embeddings = ImageEmbeddings(cfg, device)
        # the topo-only variant (use_bev=False) has no local branch
        self.local_encoder = (LocalBEVEncoder(cfg, device, lang2visn)
                              if cfg.use_bev else None)
        self.global_encoder = GlobalMapEncoder(cfg, device, lang2visn)

    def token_type_vis(self) -> torch.Tensor:
        return self.embeddings.token_type_embeddings.weight[1]

    def encode_text(self, txt_ids, txt_masks):
        return self.lang_encoder(self.embeddings(txt_ids), txt_masks)

    def encode_pano(self, batch: Batch):
        """Returns (pano_embeds (B, T, P, D), pano_masks (B, T, P))."""
        vf = batch["traj_view_fts"]
        b, t = vf.shape[:2]
        flat = lambda x: x.reshape(b * t, *x.shape[2:])
        obj_fts = batch.get("traj_obj_fts")
        x, masks = self.img_embeddings(
            flat(vf), flat(batch["traj_loc_fts"]), flat(batch["traj_nav_types"]),
            flat(batch["traj_view_lens"]),
            obj_fts=None if obj_fts is None else flat(obj_fts),
            obj_lens=None if obj_fts is None else flat(batch["traj_obj_lens"]),
            token_type_vis=self.token_type_vis(),
        )
        p = x.shape[1]
        return x.reshape(b, t, p, -1), masks.reshape(b, t, p)

    def extract_obj_embeds(self, pano_embeds, batch: Batch):
        """The last step's object slots [V:V+O) and their masks, or
        (None, None) for a batch without objects."""
        if batch.get("traj_obj_fts") is None:
            return None, None
        b = pano_embeds.shape[0]
        rows = torch.arange(b, device=pano_embeds.device)
        last = batch["traj_last_step"].long()
        obj_embeds = pano_embeds[rows, last, batch["traj_view_fts"].shape[2]:]
        obj_lens = batch["traj_obj_lens"][rows, last]
        slot = torch.arange(obj_embeds.shape[1], device=obj_embeds.device)[None, :]
        return obj_embeds, slot < obj_lens[:, None]

    def aggregate_gmap(self, pano_embeds, pano_masks, gmap_agg):
        """Node features = host-weighted sums of trajectory tokens.
        pano_embeds (B, T, P, D); gmap_agg (B, N, T*P)."""
        dt = _dt(self.cfg)
        b, t, v, d = pano_embeds.shape
        tokens = (pano_embeds * pano_masks[..., None]).reshape(b, t * v, d)
        out = torch.matmul(gmap_agg.to(dt).float(), tokens.float())
        return out.to(dt)

    def encode_bev(self, txt_embeds, batch: Batch, obj_embeds=None, obj_masks=None):
        """Returns (bev_embeds (B, cells, D), obj_embeds (B, O, D) or None)."""
        return self.local_encoder(
            txt_embeds, batch["txt_masks"], batch["bev_fts"], batch["bev_pos_fts"],
            batch["bev_masks"], batch["bev_nav_masks"], obj_embeds, obj_masks,
        )

    def forward(self, batch: Batch, return_gmap_embeds: bool = True):
        """Returns (gmap_embeds or None, bev_embeds or None, obj_embeds or
        None, obj_masks or None)."""
        txt_embeds = self.encode_text(batch["txt_ids"], batch["txt_masks"])
        pano_embeds, pano_masks = self.encode_pano(batch)
        gmap_embeds = None
        if return_gmap_embeds:
            gmap_img_fts = self.aggregate_gmap(pano_embeds, pano_masks, batch["gmap_agg"])
            gmap_embeds = self.global_encoder(
                txt_embeds, batch["txt_masks"], gmap_img_fts,
                batch["gmap_step_ids"], batch["gmap_pos_fts"],
                batch["gmap_masks"], batch["gmap_pair_dists"],
            )
        obj_embeds, obj_masks = self.extract_obj_embeds(pano_embeds, batch)
        bev_embeds = None
        if self.local_encoder is not None:
            bev_embeds, obj_embeds = self.encode_bev(txt_embeds, batch, obj_embeds, obj_masks)
        return gmap_embeds, bev_embeds, obj_embeds, obj_masks

    def forward_mlm(self, batch: Batch) -> torch.Tensor:
        """The language stream attends to each map branch through the
        branch's ``lang2visn``; the two branch outputs are summed."""
        txt_embeds = self.encode_text(batch["txt_ids"], batch["txt_masks"])
        pano_embeds, pano_masks = self.encode_pano(batch)
        lang_bias = attn_bias(batch["txt_masks"])

        gmap_img_fts = self.aggregate_gmap(pano_embeds, pano_masks, batch["gmap_agg"])
        gmap_inputs = self.global_encoder.input_embedding(
            gmap_img_fts, batch["gmap_step_ids"], batch["gmap_pos_fts"]
        )
        gmap_bias = attn_bias(batch["gmap_masks"])
        gmap_txt = txt_embeds
        for layer in self.global_encoder.x_layers:
            gmap_txt = layer.lang2visn(gmap_txt, gmap_inputs, gmap_bias, lang_bias)

        bev_inputs, bev_key_masks = self.local_encoder.with_objects(
            self.local_encoder.input_embedding(
                batch["bev_fts"], batch["bev_pos_fts"], batch["bev_nav_masks"]),
            batch["bev_masks"], *self.extract_obj_embeds(pano_embeds, batch),
        )
        bev_bias = attn_bias(bev_key_masks)
        bev_txt = txt_embeds
        for layer in self.local_encoder.x_layers:
            bev_txt = layer.lang2visn(bev_txt, bev_inputs, bev_bias, lang_bias)
        return gmap_txt + bev_txt

    def forward_sem(self, batch: Batch, sem_pred_token: str) -> torch.Tensor:
        """BEV cell embeddings for semantic prediction at three depths:
        'cattn' the full cross-modal local branch, 'sattn' self-attention
        only, 'embed' the input embeddings only."""
        if sem_pred_token == "cattn":
            # the JAX forward also encodes the panoramas, which reach the
            # cells only through the object tokens: without objects XLA drops
            # that work, and so does the port
            txt_embeds = self.encode_text(batch["txt_ids"], batch["txt_masks"])
            obj = (None, None)
            if batch.get("traj_obj_fts") is not None:
                obj = self.extract_obj_embeds(self.encode_pano(batch)[0], batch)
            return self.encode_bev(txt_embeds, batch, *obj)[0]
        if sem_pred_token not in ("sattn", "embed"):
            raise ValueError(f"unknown sem_pred_token: {sem_pred_token}")
        x = self.local_encoder.input_embedding(
            batch["bev_fts"], batch["bev_pos_fts"], batch["bev_nav_masks"]
        )
        if sem_pred_token == "sattn":
            bias = attn_bias(batch["bev_masks"])
            for layer in self.local_encoder.x_layers:
                x = layer.visn2visn(x, bias)
        return x


def sap_logits(global_head: nn.Module, local_head: nn.Module,
               fuse_linear: Optional[nn.Module], bev_center: int,
               gmap_embeds: torch.Tensor, bev_embeds: torch.Tensor, batch: Batch):
    """Global node logits, local candidate logits and their fusion onto the
    global nodes through ``fuse_map`` (backtracking included).

    Returns (global_logits (B, N), local_logits (B, K), fused_logits (B, N),
    fuse_weights (B, 1) or 0.5), all float32."""
    if fuse_linear is None:
        fuse_weights = 0.5
    else:
        fuse_weights = torch.sigmoid(fuse_linear(
            torch.cat([gmap_embeds[:, 0], bev_embeds[:, bev_center]], -1)
        ))
    global_logits = global_head(gmap_embeds)[..., 0] * fuse_weights
    global_logits = masked_fill_neg(global_logits, batch["gmap_visited_masks"])
    global_logits = masked_fill_neg(global_logits, ~batch["gmap_masks"])

    cand_embeds = gather_tokens(bev_embeds, batch["bev_cand_idxs"])
    local_logits = local_head(cand_embeds)[..., 0] * (1.0 - fuse_weights)
    local_logits = masked_fill_neg(local_logits, ~batch["local_masks"])

    local_safe = torch.where(batch["local_masks"], local_logits,
                             torch.zeros_like(local_logits))
    fused_logits = global_logits + torch.einsum(
        "bnk,bk->bn", batch["fuse_map"].float(), local_safe
    )
    return global_logits, local_logits, fused_logits, fuse_weights


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100):
    """Per-example CE with an ignore label. logits (B, C); labels (B,) int.
    Returns (loss (B,) float32, valid (B,) bool)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def _global_counts(*counts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``counts`` (int64 device scalars) summed over the data-parallel
    ranks, in one collective; one process: as they are."""
    if not distributed.active():
        return counts
    return tuple(distributed.all_reduce_(torch.stack(counts)).unbind())


def _hits(logits, labels, valid) -> torch.Tensor:
    return ((logits.argmax(-1) == labels) & valid).sum()


class GlocalTextPathCMTPreTraining(nn.Module):
    """Backbone + proxy-task heads + per-task losses. ``forward(batch, task)``
    returns (scalar loss, metrics dict of device tensors). Tasks: ``mlm``,
    ``mrc``, ``sap``, ``og``, ``sem``, ``masksem``; ``mrc`` and ``og`` need
    batches with object slots."""

    def __init__(self, cfg: ModelConfig, tasks: Tuple[str, ...] = ("mlm", "sap", "masksem"),
                 sem_pred_token: str = "cattn", device=None):
        super().__init__()
        bases = {t.split("_")[0] for t in tasks}
        if bases & {"mrc", "og"} and cfg.obj_feat_size <= 0:
            raise ValueError("mrc and og need object tokens (obj_feat_size > 0)")
        if not cfg.use_bev:
            raise ValueError("pretraining needs the local BEV branch (use_bev=True)")
        if "mlm" in bases and not cfg.use_lang2visn_attn:
            raise ValueError("mlm needs the language branch (use_lang2visn_attn=True)")
        self.cfg = cfg
        self.tasks = tuple(tasks)
        self.sem_pred_token = sem_pred_token
        hid = cfg.hidden_size
        self.bert = GlocalTextPathCMT(cfg, device, lang2visn="mlm" in bases)
        self.feat_dropout = Dropout(cfg.feat_dropout, site="feat")
        if "mlm" in bases:
            self.mlm_head = MlmHead(cfg, device)
        if "mrc" in bases:
            self.obj_classifier = TwoLayerHead(cfg, cfg.obj_prob_size, device=device)
        if "sap" in bases:
            self.global_sap_head = TwoLayerHead(cfg, 1, device=device)
            self.local_sap_head = TwoLayerHead(cfg, 1, device=device)
            self.sap_fuse_linear = (TwoLayerHead(cfg, 1, in_features=2 * hid, device=device)
                                    if cfg.glocal_fuse else None)
        if "og" in bases:
            self.og_head = TwoLayerHead(cfg, 1, device=device)
        if bases & {"sem", "masksem"}:
            self.local_sem_head = TwoLayerHead(cfg, cfg.num_sem_classes, device=device)

    def drop_feats(self, batch: Batch) -> Batch:
        """Env-feature dropout on the view, object and BEV features."""
        out = dict(batch)
        for key in ("traj_view_fts", "traj_obj_fts", "bev_fts"):
            if out.get(key) is not None:
                out[key] = self.feat_dropout(out[key])
        return out

    def forward(self, batch: Batch, task: str):
        batch = self.drop_feats(batch)
        fn = {"mlm": self.forward_mlm, "mrc": self.forward_mrc, "sap": self.forward_sap,
              "og": self.forward_og, "sem": self.forward_sem,
              "masksem": self.forward_masksem}[task.split("_")[0]]
        return fn(batch)

    def forward_mlm(self, batch: Batch):
        txt_embeds = self.bert.forward_mlm(batch)
        hidden = gather_tokens(txt_embeds, batch["mlm_pos"])  # (B, M, D)
        logits = self.mlm_head(hidden, self.bert.embeddings.word_embeddings.weight)
        b, m, v = logits.shape
        tgt = batch["mlm_tgt"].reshape(-1).long()
        labels = torch.where(batch["mlm_valid"].reshape(-1), tgt, torch.full_like(tgt, -100))
        loss, valid = cross_entropy(logits.reshape(b * m, v), labels)
        n, hits = _global_counts(valid.sum(), _hits(logits.reshape(b * m, v), tgt, valid))
        n = n.clamp_min(1)
        return loss.sum() / n, {"mlm_acc": hits / n, "mlm_n": n}

    def forward_sap(self, batch: Batch):
        gmap_embeds, bev_embeds, _, _ = self.bert(batch)
        global_logits, local_logits, fused_logits, _ = sap_logits(
            self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
            self.cfg.bev_center, gmap_embeds, bev_embeds, batch,
        )
        glabels, llabels = batch["global_act_labels"].long(), batch["local_act_labels"].long()
        g_loss, g_valid = cross_entropy(global_logits, glabels)
        l_loss, l_valid = cross_entropy(local_logits, llabels)
        f_loss, _ = cross_entropy(fused_logits, glabels)
        # -100 rows drop out of all three
        n, g_hits, l_hits, f_hits = _global_counts(
            g_valid.sum(), _hits(global_logits, glabels, g_valid),
            _hits(local_logits, llabels, l_valid), _hits(fused_logits, glabels, g_valid))
        n = n.clamp_min(1)
        rows = glabels.shape[0] * distributed.world_size()
        loss = (g_loss + l_loss + f_loss).sum() / max(rows, 1)
        return loss, {"sap_gacc": g_hits / n, "sap_lacc": l_hits / n,
                      "sap_facc": f_hits / n, "sap_n": n}

    def forward_og(self, batch: Batch):
        """Object grounding: cross-entropy over the last step's object slots."""
        _, _, obj_embeds, obj_masks = self.bert(batch, return_gmap_embeds=False)
        logits = masked_fill_neg(self.og_head(obj_embeds)[..., 0], ~obj_masks)
        labels = batch["obj_labels"].long()
        loss, valid = cross_entropy(logits, labels)
        n, hits = _global_counts(valid.sum(), _hits(logits, labels, valid))
        n = n.clamp_min(1)
        return loss.sum() / n, {"og_acc": hits / n, "og_n": n}

    def forward_mrc(self, batch: Batch):
        """Masked region classification: KL(obj_probs || prediction) summed
        over classes, averaged over the masked valid object slots."""
        _, _, obj_embeds, obj_masks = self.bert(batch, return_gmap_embeds=False)
        logp = torch.log_softmax(self.obj_classifier(obj_embeds), dim=-1)
        targets = batch["obj_probs"].float()
        kl = (targets * (torch.log(targets.clamp_min(1e-12)) - logp)).sum(-1)
        sel = batch["obj_mrc_masks"] & obj_masks
        (n,) = _global_counts(sel.sum())
        n = n.clamp_min(1)
        return torch.where(sel, kl, torch.zeros_like(kl)).sum() / n, {"mrc_n": n}

    def _sem_loss(self, bev_embeds: torch.Tensor, batch: Batch, sel: torch.Tensor):
        """Masked multi-label BCE with logits over the selected cells."""
        logits = self.local_sem_head(bev_embeds)  # (B, C, num_sem) float32
        labels = batch["bev_sems"].float()
        bce = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
        (n,) = _global_counts(sel.sum())
        n = n.clamp_min(1)
        loss = torch.where(sel[..., None], bce, torch.zeros_like(bce)).sum() / (
            n * labels.shape[-1])
        mean = logits.mean()
        if distributed.active():  # every rank holds as many logits
            mean = distributed.all_reduce_(mean.detach()) / distributed.world_size()
        return loss, {"sem_n": n, "sem_logits_mean": mean}

    def forward_sem(self, batch: Batch):
        bev_embeds = self.bert.forward_sem(batch, self.sem_pred_token)
        return self._sem_loss(bev_embeds, batch, batch["bev_sem_masks"])

    def forward_masksem(self, batch: Batch):
        masked = dict(batch)
        masked["bev_fts"] = torch.where(batch["bev_mrc_masks"][..., None],
                                        torch.zeros_like(batch["bev_fts"]), batch["bev_fts"])
        bev_embeds = self.bert.forward_sem(masked, self.sem_pred_token)
        sel = batch["bev_sem_masks"] & batch["bev_mrc_masks"]
        return self._sem_loss(bev_embeds, batch, sel)
