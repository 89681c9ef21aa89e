"""The glocal (global topo-map + local BEV-map) cross-modal model and its
pretraining heads (port of ``vln_bevbert_tpu/models/glocal.py``).

Batch keys are the JAX package's static-shape contract (see its module
docstring), as torch tensors. Object tokens (REVERIE/SOON) and the tasks that
need them (``mrc``, ``og``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import ModelConfig
from ..ops.dropout import Dropout
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
        """Returns (pano_embeds (B, T, V, D), pano_masks (B, T, V))."""
        vf = batch["traj_view_fts"]
        b, t = vf.shape[:2]
        flat = lambda x: x.reshape(b * t, *x.shape[2:])
        x, masks = self.img_embeddings(
            flat(vf), flat(batch["traj_loc_fts"]), flat(batch["traj_nav_types"]),
            flat(batch["traj_view_lens"]), token_type_vis=self.token_type_vis(),
        )
        v = x.shape[1]
        return x.reshape(b, t, v, -1), masks.reshape(b, t, v)

    def aggregate_gmap(self, pano_embeds, pano_masks, gmap_agg):
        """Node features = host-weighted sums of trajectory tokens.
        pano_embeds (B, T, V, D); gmap_agg (B, N, T*V)."""
        dt = _dt(self.cfg)
        b, t, v, d = pano_embeds.shape
        tokens = (pano_embeds * pano_masks[..., None]).reshape(b, t * v, d)
        out = torch.matmul(gmap_agg.to(dt).float(), tokens.float())
        return out.to(dt)

    def encode_bev(self, txt_embeds, batch: Batch):
        return self.local_encoder(
            txt_embeds, batch["txt_masks"], batch["bev_fts"], batch["bev_pos_fts"],
            batch["bev_masks"], batch["bev_nav_masks"],
        )

    def forward(self, batch: Batch, return_gmap_embeds: bool = True):
        """Returns (gmap_embeds or None, bev_embeds or None)."""
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
        bev_embeds = None
        if self.local_encoder is not None:
            bev_embeds = self.encode_bev(txt_embeds, batch)
        return gmap_embeds, bev_embeds

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

        bev_inputs = self.local_encoder.input_embedding(
            batch["bev_fts"], batch["bev_pos_fts"], batch["bev_nav_masks"]
        )
        bev_bias = attn_bias(batch["bev_masks"])
        bev_txt = txt_embeds
        for layer in self.local_encoder.x_layers:
            bev_txt = layer.lang2visn(bev_txt, bev_inputs, bev_bias, lang_bias)
        return gmap_txt + bev_txt

    def forward_sem(self, batch: Batch, sem_pred_token: str) -> torch.Tensor:
        """BEV cell embeddings for semantic prediction at three depths:
        'cattn' the full cross-modal local branch, 'sattn' self-attention
        only, 'embed' the input embeddings only."""
        if sem_pred_token == "cattn":
            # the JAX forward also encodes the panoramas, for object tokens
            # only; without them XLA drops that work, and so does the port
            txt_embeds = self.encode_text(batch["txt_ids"], batch["txt_masks"])
            return self.encode_bev(txt_embeds, batch)
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


def _count(valid: torch.Tensor) -> torch.Tensor:
    """max(number of True, 1), as a device tensor."""
    return valid.sum().clamp_min(1)


def _accuracy(logits, labels, valid, n) -> torch.Tensor:
    return ((logits.argmax(-1) == labels) & valid).sum() / n


class GlocalTextPathCMTPreTraining(nn.Module):
    """Backbone + proxy-task heads + per-task losses. ``forward(batch, task)``
    returns (scalar loss, metrics dict of device tensors). Tasks: ``mlm``,
    ``sap``, ``sem``, ``masksem``."""

    def __init__(self, cfg: ModelConfig, tasks: Tuple[str, ...] = ("mlm", "sap", "masksem"),
                 sem_pred_token: str = "cattn", device=None):
        super().__init__()
        bases = {t.split("_")[0] for t in tasks}
        if bases & {"mrc", "og"}:
            raise NotImplementedError("mrc and og need object tokens, not ported yet")
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
        if "sap" in bases:
            self.global_sap_head = TwoLayerHead(cfg, 1, device=device)
            self.local_sap_head = TwoLayerHead(cfg, 1, device=device)
            self.sap_fuse_linear = (TwoLayerHead(cfg, 1, in_features=2 * hid, device=device)
                                    if cfg.glocal_fuse else None)
        if bases & {"sem", "masksem"}:
            self.local_sem_head = TwoLayerHead(cfg, cfg.num_sem_classes, device=device)

    def drop_feats(self, batch: Batch) -> Batch:
        """Env-feature dropout on the view and BEV features."""
        out = dict(batch)
        for key in ("traj_view_fts", "bev_fts"):
            out[key] = self.feat_dropout(out[key])
        return out

    def forward(self, batch: Batch, task: str):
        batch = self.drop_feats(batch)
        fn = {"mlm": self.forward_mlm, "sap": self.forward_sap,
              "sem": self.forward_sem, "masksem": self.forward_masksem}[task.split("_")[0]]
        return fn(batch)

    def forward_mlm(self, batch: Batch):
        txt_embeds = self.bert.forward_mlm(batch)
        hidden = gather_tokens(txt_embeds, batch["mlm_pos"])  # (B, M, D)
        logits = self.mlm_head(hidden, self.bert.embeddings.word_embeddings.weight)
        b, m, v = logits.shape
        tgt = batch["mlm_tgt"].reshape(-1).long()
        labels = torch.where(batch["mlm_valid"].reshape(-1), tgt, torch.full_like(tgt, -100))
        loss, valid = cross_entropy(logits.reshape(b * m, v), labels)
        n = _count(valid)
        acc = _accuracy(logits.reshape(b * m, v), tgt, valid, n)
        return loss.sum() / n, {"mlm_acc": acc, "mlm_n": n}

    def forward_sap(self, batch: Batch):
        gmap_embeds, bev_embeds = self.bert(batch)
        global_logits, local_logits, fused_logits, _ = sap_logits(
            self.global_sap_head, self.local_sap_head, self.sap_fuse_linear,
            self.cfg.bev_center, gmap_embeds, bev_embeds, batch,
        )
        glabels, llabels = batch["global_act_labels"].long(), batch["local_act_labels"].long()
        g_loss, g_valid = cross_entropy(global_logits, glabels)
        l_loss, l_valid = cross_entropy(local_logits, llabels)
        f_loss, _ = cross_entropy(fused_logits, glabels)
        n = _count(g_valid)  # -100 rows drop out of all three
        loss = (g_loss + l_loss + f_loss).sum() / max(glabels.shape[0], 1)
        return loss, {
            "sap_gacc": _accuracy(global_logits, glabels, g_valid, n),
            "sap_lacc": _accuracy(local_logits, llabels, l_valid, n),
            "sap_facc": _accuracy(fused_logits, glabels, g_valid, n),
            "sap_n": n,
        }

    def _sem_loss(self, bev_embeds: torch.Tensor, batch: Batch, sel: torch.Tensor):
        """Masked multi-label BCE with logits over the selected cells."""
        logits = self.local_sem_head(bev_embeds)  # (B, C, num_sem) float32
        labels = batch["bev_sems"].float()
        bce = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
        n = _count(sel)
        loss = torch.where(sel[..., None], bce, torch.zeros_like(bce)).sum() / (
            n * labels.shape[-1])
        return loss, {"sem_n": n, "sem_logits_mean": logits.mean()}

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
