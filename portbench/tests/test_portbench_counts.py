"""The work counted from shapes, against hand-worked numbers."""

from __future__ import annotations

import pytest
import torch

from portbench import counts
from portbench.reference import model as rmodel


def test_flops_and_dropout_bytes_of_a_dense_layer_and_one_site():
    """x (8, 16) -> Dense(16, 32) -> dropout -> sum. Forward: 2*8*16*32
    FLOPs; backward: the weight's gradient, 2*8*16*32 more (x needs none).
    The site moves its bf16 input and output forward (8*32*2 bytes each)
    and the gradient in and out backward (the same again)."""
    num = rmodel.Numerics(torch.bfloat16)
    with torch.device("meta"):
        dense = rmodel.Dense(num, 16, 32)
        drop = rmodel.Dropout(0.1)

    def loss_of(task, batch):
        return drop(dense(batch["x"])).float().sum()

    counter = counts.StepCounts(torch.nn.ModuleList([dense, drop]), loss_of)
    flops, moved = counter("any", (("x", (8, 16), "float32"),))
    assert flops == 2 * (2 * 8 * 16 * 32)
    assert moved == 4 * 8 * 32 * 2
    assert counter.cache  # counted once per (task, signature)


def test_a_site_the_loss_does_not_reach_moves_only_forward():
    with torch.device("meta"):
        drop = rmodel.Dropout(0.4)
        w = torch.nn.Parameter(torch.empty(3))

    def loss_of(task, batch):
        drop(batch["x"])  # its output feeds nothing
        return (batch["y"] * w).sum()

    sig = (("x", (4, 10), "float32"), ("y", (3,), "float32"))
    flops, moved = counts.StepCounts(drop, loss_of)("t", sig)
    assert flops == 0
    assert moved == 2 * 4 * 10 * 4


def test_attention_flops_at_bert_base_widths():
    """One self-attention block at B=2, L=64, hidden 768, 12 heads: qkv
    2*B*L*768*2304, scores and context 2 * 2*B*12*64*64*64, the output
    projection 2*B*L*768*768; forward only."""
    from types import SimpleNamespace

    cfg = SimpleNamespace(hidden_size=768, num_attention_heads=12, layer_norm_eps=1e-12,
                          attention_probs_dropout_prob=0.1, hidden_dropout_prob=0.1)
    with torch.device("meta"):
        block = rmodel.AttentionBlock(cfg, rmodel.Numerics(torch.bfloat16))
    block.eval()
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(2, 64, 768, device="meta", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        block(x, x)
    B, L, D, H = 2, 64, 768, 12
    want = 2 * B * L * D * 3 * D + 2 * (2 * B * H * L * L * (D // H)) + 2 * B * L * D * D
    assert fc.get_total_flops() == want


def test_splat_bytes():
    # 2352 cells read, 1000 valid rows of 768 f16 features and int32 labels,
    # 441 x 809 float32 sums written
    assert counts.splat_bytes(1000, 2352, 768, 2, 441, 809, True) == (
        4 * 2352 + 1000 * (768 * 2 + 4) + 441 * 809 * 4)
    assert counts.splat_bytes(0, 10, 8, 2, 4, 9, False) == 4 * 10 + 4 * 9 * 4


def test_shares_of_the_peaks():
    # 3.35 GB moved in 2 ms is half the HBM peak; 989 GFLOP in 2 s is 0.05%
    assert counts.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert counts.mfu_pct(989e9, 2.0) == pytest.approx(0.05)


def test_signature_is_what_the_program_keys_a_graph_by():
    import numpy as np

    batch = {"b": np.zeros((2, 3), np.float16), "a": np.zeros(4, bool)}
    assert counts.signature(batch) == (("a", (4,), "bool"), ("b", (2, 3), "float16"))
    meta = counts.meta_batch(counts.signature(batch))
    assert meta["b"].dtype == torch.float16 and meta["a"].shape == (4,)
