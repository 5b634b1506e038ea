"""The numerics of the port's bf16 flash-attention forward
(kubegpu_tpu_torch/ops/attention.py), on the CPU.

The bf16 kernel K3 feeds p to the tensor cores rounded to bf16 for
``p . v``, and sums ``l`` from the unrounded f32 p.  Its plain twin
carries that as ``operand_dtype=torch.bfloat16`` (the emulation), and
``None`` stays the float32 algebra that the JAX parity tests hold
against the Pallas kernel.  These tests pin both, as
tests/test_torch_flash_backward_bf16.py does for the backward: ``None`` is
the float32 algebra bit for bit; the emulation stays within a
norm-relative bound of it and keeps lse bit for bit; rows with nothing
to attend stay empty; and the block gate (``bf16_emulation_shares``)
fails a forward that drops one K tile.  The card-side gates are in
tests/test_torch_cuda_kernels.py."""

import math

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.ops.attention import (
    bf16_emulation_shares,
    flash_forward,
    flash_forward_plain,
)

# ||emulation - f32 twin|| / ||f32 twin|| over a whole out.  Each term of
# p . v carries one bf16 rounding of p (relative 2^-9 on average, at most
# 2^-8) and the result one more; the errors have random sign, so the
# norm-relative error sits near 2^-9 and 2^-7 leaves a factor of four.
EMULATION_REL = 2 ** -7

SHAPES = [
    # causal, sq, sk, d
    (True, 48, 48, 8),
    (True, 100, 100, 40),
    (False, 40, 72, 64),
    (False, 72, 40, 128),
    (True, 64, 64, 128),
]


def inputs(causal, sq, sk, d, b=2, h=2, seed=0, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed + sq + d)
    return [torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
            .to(dtype) for n in (sq, sk, sk)]


def seed_algebra(q, k, v, causal):
    """The forward twin's float32 algebra as it stood before the
    emulation existed: dense scores scaled after the dot, the Pallas
    guards, out rounded once to q's dtype, lse float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        valid = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
        scores = torch.where(valid, scores, float("-inf"))
    m = scores.amax(-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - shift)
    l = p.sum(-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / denom
    lse = torch.where(l > 0.0, torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(denom), float("-inf"))
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse[..., 0]


def rel_err(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, sq, sk, d", SHAPES[:3])
def test_forward_twin_without_operand_dtype_is_the_f32_algebra_bit_for_bit(
        dtype, causal, sq, sk, d):
    q, k, v = inputs(causal, sq, sk, d, dtype=dtype)
    want_out, want_lse = seed_algebra(q, k, v, causal)
    for out, lse in (flash_forward_plain(q, k, v, causal),
                     flash_forward_plain(q, k, v, causal,
                                         operand_dtype=None)):
        assert out.dtype == dtype and torch.equal(out, want_out)
        assert torch.equal(lse, want_lse)


@pytest.mark.parametrize("causal, sq, sk, d", SHAPES)
def test_bf16_forward_emulation_stays_within_its_bound_of_the_f32_twin(
        causal, sq, sk, d):
    """The emulation on bf16 operands against the float32 twin fed the
    same bf16 values as float32 (exact), which returns float32: out
    within EMULATION_REL by norm, lse bit for bit (l is summed from the
    unrounded p)."""
    q, k, v = inputs(causal, sq, sk, d)
    ref, ref_lse = flash_forward_plain(*(t.float() for t in (q, k, v)),
                                       causal)
    emu, emu_lse = flash_forward_plain(q, k, v, causal,
                                       operand_dtype=torch.bfloat16)
    assert emu.dtype == torch.bfloat16 and ref.dtype == torch.float32
    assert torch.equal(emu_lse, ref_lse)
    err = rel_err(emu, ref)
    assert 0.0 < err <= EMULATION_REL, err
    # p really is rounded before p . v: the emulation is not the f32
    # twin rounded once
    assert not torch.equal(emu, ref.to(torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_emulation_keeps_empty_rows_empty(causal):
    """Rows with nothing to attend (every score -inf: batch 0's keys hold
    -inf in a column where its queries are positive) get out 0 and lse
    -inf in the emulation as in the float32 twin; batch 1 stays within
    the bound."""
    q, k, v = inputs(causal, 64, 64, 32)
    q[0, :, :, 0] = q[0, :, :, 0].abs() + 0.5
    k[0, :, :, 0] = float("-inf")
    ref, ref_lse = flash_forward_plain(*(t.float() for t in (q, k, v)),
                                       causal)
    emu, emu_lse = flash_forward_plain(q, k, v, causal,
                                       operand_dtype=torch.bfloat16)
    assert (emu[0] == 0).all() and (ref[0] == 0).all()
    assert torch.isinf(emu_lse[0]).all() and (emu_lse[0] < 0).all()
    assert torch.equal(emu_lse, ref_lse)
    assert torch.isfinite(emu.float()).all()
    assert rel_err(emu[1], ref[1]) <= EMULATION_REL


def test_forward_emulation_on_the_cpu_wrapper_is_not_taken():
    """The wrapper on CPU tensors is the float32 algebra (the twin without
    ``operand_dtype``), whatever the dtype: the emulation is a yardstick,
    never the CPU path."""
    q, k, v = inputs(True, 48, 48, 16)
    before = flash_forward.launches
    out, lse = flash_forward(q, k, v, True)
    assert flash_forward.launches == before
    want_out, want_lse = seed_algebra(q, k, v, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


def test_emulation_gate_catches_a_forward_that_drops_one_k_tile():
    """A K3 that skipped one 64-column K tile (the diagonal tile of the
    last 64 causal rows, about a seventh of those rows' weight) fails the
    block gate against the emulation; the emulation itself passes with
    share 0."""
    causal, s, d = True, 256, 64
    q, k, v = inputs(causal, s, s, d)
    emu, _ = flash_forward_plain(q, k, v, causal,
                                 operand_dtype=torch.bfloat16)
    assert bf16_emulation_shares(emu, emu) == (0.0, 0.0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    keep = torch.tril(torch.ones(s, s, dtype=torch.bool))
    keep[192:256, 192:256] = False
    scores = torch.where(keep, scores, float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    bad = (torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                        v.float())
           / p.sum(-1).transpose(1, 2)[..., None]).to(torch.bfloat16)
    assert bf16_emulation_shares(bad, emu)[1] > 1.0
