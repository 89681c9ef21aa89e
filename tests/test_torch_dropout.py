"""The port's seeded dropout (vln_bevbert_tpu_torch/ops/dropout.py) through its
plain version, which the CPU runs and which the card holds the CUDA kernel
to bit for bit.

Its mask stream is not JAX's (the JAX package's own CPU path draws
``jax.random.bernoulli``), so parity is in distribution: P(keep) within five
binomial standard deviations of 1 - rate. The bits themselves are held to a
scalar Philox4x32-10 written here from its definition (Salmon et al., SC'11),
itself held to the published known-answer vectors of Random123.
"""

import math

import numpy as np
import pytest
import torch

from vln_bevbert_tpu_torch.ops.dropout import (
    Dropout,
    draw_seeds,
    dropout,
    dropout_apply,
    dropout_ref,
    philox_bits,
    set_dropout_generator,
    threshold_and_scale,
)
from vln_bevbert_tpu_torch.utils.rng import make_generator, train_generator

M32 = 0xFFFFFFFF


def philox4x32_10(ctr, key):
    """Scalar Philox4x32-10 on Python ints."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & M32, p1 & M32, ((p0 >> 32) ^ c[3] ^ k1) & M32, p0 & M32]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


def test_scalar_philox_matches_known_answers():
    assert philox4x32_10([0, 0, 0, 0], (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert philox4x32_10([M32] * 4, (M32, M32)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert philox4x32_10([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
                         (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


@pytest.mark.parametrize("row_len", [1, 7, 16, 45])
def test_philox_bits_match_the_scalar_generator(row_len):
    seeds = torch.tensor([0, 1, -1, -(2 ** 31), 2 ** 31 - 1, 0x1234567], dtype=torch.int32)
    bits = philox_bits(seeds, row_len)
    assert bits.shape == (len(seeds), row_len) and bits.dtype == torch.int64
    for r, seed in enumerate(seeds.tolist()):
        want = []
        for g in range(-(-row_len // 4)):
            want += philox4x32_10([g & M32, g >> 32, 0, 0], (seed & M32, 0))
        assert bits[r].tolist() == want[:row_len]


def test_threshold_is_unsigned_and_capped():
    assert threshold_and_scale(0.0) == (0, 1.0)
    assert threshold_and_scale(0.1)[0] == round(0.1 * 2 ** 32) > 2 ** 28
    assert threshold_and_scale(0.6)[0] > 2 ** 31  # above int32: compared unsigned
    assert threshold_and_scale(1.0 - 2 ** -40)[0] == M32
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            threshold_and_scale(bad)


@pytest.mark.parametrize("rate", [0.1, 0.4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keep_rate_and_kept_values(rate, dtype):
    x = (torch.rand(16, 3, 1000, generator=make_generator(0)) + 0.5).to(dtype)
    seeds = draw_seeds(16, make_generator(1), "cpu")
    y = dropout_ref(x, seeds, rate)
    assert y.dtype == dtype and y.shape == x.shape
    kept = y != 0
    n = kept.numel()
    sd = math.sqrt(rate * (1 - rate) / n)
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * sd
    # kept values are float(x) * (1 / (1 - rate)) rounded once to x's type
    want = (x.float() * (1.0 / (1.0 - rate))).to(dtype)
    assert torch.equal(y[kept], want[kept])
    torch.testing.assert_close(y[kept].float(), x[kept].float() / (1 - rate),
                               rtol=2 ** -7 if dtype == torch.bfloat16 else 1e-6, atol=0)
    # P(keep) does not drift between rows, and the bits are those of philox_bits
    bits = philox_bits(seeds, 3 * 1000).reshape(x.shape)
    assert torch.equal(kept, bits >= threshold_and_scale(rate)[0])


def test_mask_is_a_function_of_seed_and_offset_only():
    x = torch.randn(3, 10, 6)
    seeds = torch.tensor([5, 5, 6], dtype=torch.int32)
    y = dropout_ref(x, seeds, 0.5)
    assert torch.equal(y[0] != 0, (y[1] != 0))           # equal seeds, equal masks
    assert not torch.equal(y[0] != 0, y[2] != 0)
    flat = dropout_ref(x.reshape(3, 60), seeds, 0.5)     # the row's layout is irrelevant
    assert torch.equal(flat.reshape(3, 10, 6), y)
    assert torch.equal(dropout_ref(x, seeds, 0.0), x)    # rate 0 is the identity


def test_backward_regenerates_the_forward_mask_and_saves_only_seeds():
    x = torch.randn(4, 7, 9, requires_grad=True)
    seeds = draw_seeds(4, make_generator(2), "cpu")
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = dropout(x, seeds, 0.3)
    assert len(packed) == 1 and packed[0] is seeds        # the seed vector only
    assert [t.dtype for t in y.grad_fn.saved_tensors] == [torch.int32]
    dy = torch.randn_like(y)
    y.backward(dy)
    assert torch.equal(x.grad != 0, y != 0)              # the same mask, bitwise
    assert torch.equal(x.grad, dropout_ref(dy, seeds, 0.3))
    # an input that needs no gradient records nothing
    z = dropout(x.detach(), seeds, 0.3)
    assert z.grad_fn is None and torch.equal(z, y.detach())


def test_dropout_module_routes_and_draws_from_its_generator():
    drop = Dropout(0.4, site="feat")
    x = torch.randn(5, 11)
    assert drop.eval()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    set_dropout_generator(drop, train_generator(7))
    before = dropout_apply.launches
    a = drop(x)
    set_dropout_generator(drop, train_generator(7))
    assert torch.equal(drop(x), a)                       # same seed, same masks
    assert not torch.equal(drop(x), a)                   # the stream advances
    assert dropout_apply.launches == before              # CPU: the plain version
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] * (1 / 0.6))
    v = drop(torch.ones(4000))                           # rank 1: bernoulli
    assert abs((v != 0).float().mean().item() - 0.6) < 5 * math.sqrt(0.24 / 4000)


def test_dropout_apply_rejects_mixed_devices():
    x = torch.randn(2, 8)
    seeds = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dropout_apply(x.to("meta"), seeds.to("meta"), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        dropout_apply(x, seeds.to("meta"), 0.1)


def test_train_generator_differs_from_the_init_stream():
    a = torch.randint(2 ** 31, (8,), generator=train_generator(3))
    b = torch.randint(2 ** 31, (8,), generator=make_generator(3))
    assert not torch.equal(a, b)
    assert torch.equal(a, torch.randint(2 ** 31, (8,), generator=train_generator(3)))
    np.testing.assert_array_equal(draw_seeds(3, make_generator(4), "cpu").numpy(),
                                  draw_seeds(3, make_generator(4), "cpu").numpy())
