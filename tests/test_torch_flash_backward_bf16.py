"""The numerics of the port's bf16 flash-attention backward
(kubegpu_tpu_torch/ops/attention.py), on the CPU.

The bf16 kernels K4 (dK, dV) and K5 (dQ) feed p and ds to the tensor
cores rounded to bf16, with f32 sums.  Their plain twins carry that as
``operand_dtype=torch.bfloat16`` (the emulation), and ``None`` stays the
float32 algebra that the JAX parity tests hold against the Pallas
kernels.  These tests pin both: ``None`` is the float32 algebra bit for
bit; the emulation stays within a norm-relative bound of it; the delta
pre-pass's twin is the Pallas ``_bwd_block``'s delta; and the wrappers
give one result with and without a precomputed delta (bf16; float32
refuses one).  The card-side gates (kernel within twice the emulation's
error of the float32 twin, and within ``bf16_emulation_shares``'s
allowances of the emulation) are in tests/test_torch_cuda_kernels.py;
here the second gate is shown to catch a kernel that drops one q tile."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.attention import _bwd_block
from kubegpu_tpu_torch.ops.attention import (
    BF16_ATOL,
    _aligned,
    _backward_probs,
    bf16_emulation_shares,
    bf16_gradient_allowance,
    flash_attention,
    flash_backward_delta,
    flash_backward_delta_plain,
    flash_backward_dkdv,
    flash_backward_dkdv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward_plain,
)

# ||emulation - f32 twin|| / ||f32 twin|| over a whole gradient.  Each
# term of each sum carries one bf16 rounding of p or ds (relative 2^-9 on
# average, at most 2^-8), and the result one more; the errors have random
# sign, so the norm-relative error sits near 2^-9 and 2^-7 leaves a
# factor of four for cancellation in the sums.
EMULATION_REL = 2 ** -7
GRAD_TOL = 1e-4

SHAPES = [
    # causal, sq, sk, d
    (True, 48, 48, 8),
    (True, 100, 100, 40),
    (False, 40, 72, 64),
    (False, 72, 40, 128),
    (True, 64, 64, 128),
]


def residuals(causal, sq, sk, d, b=2, h=2, seed=0, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) q, k, v, dout from numpy, and the twin
    forward's out and lse on them."""
    rng = np.random.RandomState(seed + sq + d)
    q, k, v, dout = (torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
                     .to(dtype) for n in (sq, sk, sk, sq))
    out, lse = flash_forward_plain(q, k, v, causal)
    return q, k, v, out, lse, dout


def grads(q, k, v, out, lse, dout, causal, **kw):
    dk, dv = flash_backward_dkdv_plain(q, k, v, out, lse, dout, causal, **kw)
    return flash_backward_dq_plain(q, k, v, out, lse, dout, causal, **kw), dk, dv


def seed_algebra(q, k, v, out, lse, dout, causal):
    """The backward twins' float32 algebra as it stood before the
    emulation existed: dense scores, p from lse, delta from the stored
    out, ds; dq, dk, dv rounded once to the inputs' dtype."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    lse_col = lse.float()[..., None]
    finite = torch.isfinite(lse_col)
    keep = finite
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = keep & (torch.arange(sk)[None, :] <= torch.arange(sq)[:, None])
    p = torch.where(keep, torch.exp(scores - torch.where(finite, lse_col, 0.0)),
                    0.0)
    dof = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype).contiguous()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype).contiguous()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype).contiguous()
    return dq, dk, dv


def rel_err(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, sq, sk, d", SHAPES[:3])
def test_twins_without_operand_dtype_are_the_f32_algebra_bit_for_bit(
        dtype, causal, sq, sk, d):
    res = residuals(causal, sq, sk, d, dtype=dtype)
    want = seed_algebra(*res, causal)
    for got in (grads(*res, causal), grads(*res, causal, operand_dtype=None)):
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("causal, sq, sk, d", SHAPES)
def test_bf16_emulation_stays_within_its_bound_of_the_f32_twin(causal, sq, sk,
                                                               d):
    """The emulation on bf16 operands against the float32 twin fed the
    same bf16 values as float32 (exact), which returns float32."""
    q, k, v, out, lse, dout = residuals(causal, sq, sk, d)
    f32 = grads(*(t.float() for t in (q, k, v, out)), lse, dout.float(), causal)
    emu = grads(q, k, v, out, lse, dout, causal, operand_dtype=torch.bfloat16)
    for name, e, w in zip(("dq", "dk", "dv"), emu, f32):
        assert e.dtype == torch.bfloat16 and w.dtype == torch.float32
        err = rel_err(e, w)
        assert 0.0 < err <= EMULATION_REL, (name, err)
        # the emulation differs from the f32 twin rounded once: p and ds
        # really are rounded before their products
        assert not torch.equal(e, w.to(torch.bfloat16)), name


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_emulation_keeps_empty_rows_empty(causal):
    """Rows whose lse is -inf (and out 0), as in
    test_backward_twins_match_the_pallas_kernels_with_empty_rows: p is 0
    there, so the emulation's dq rows are exactly 0 and the bound holds."""
    q, k, v, out, lse, dout = residuals(causal, 64, 64, 32)
    empty = [0, 5, 33]
    lse = lse.clone()
    lse[:, :, empty] = float("-inf")
    out = out.clone()
    out[:, empty] = 0
    f32 = grads(*(t.float() for t in (q, k, v, out)), lse, dout.float(), causal)
    emu = grads(q, k, v, out, lse, dout, causal, operand_dtype=torch.bfloat16)
    assert (emu[0][:, empty] == 0).all() and (f32[0][:, empty] == 0).all()
    for e, w in zip(emu, f32):
        assert torch.isfinite(e.float()).all()
        assert rel_err(e, w) <= EMULATION_REL


def test_bf16_gradient_allowance_is_twice_the_emulation_error_plus_atol():
    assert bf16_gradient_allowance(0.0) == BF16_ATOL
    assert bf16_gradient_allowance(0.25) == 0.5 + BF16_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_twin_is_the_backward_algebras_delta(dtype):
    """The pre-pass's twin equals the delta the Pallas _bwd_block takes
    (rowsum(dO * O)), and ds through a precomputed delta equals ds
    without one, bit for bit."""
    causal = True
    q, k, v, out, lse, dout = residuals(causal, 40, 40, 16, dtype=dtype)
    delta = flash_backward_delta_plain(out, dout)
    assert delta.shape == (2, 2, 40) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    p0, ds0 = _backward_probs(q, k, v, out, lse, dout, causal)
    p1, ds1 = _backward_probs(q, k, v, out, lse, dout, causal, delta)
    assert torch.equal(p0, p1) and torch.equal(ds0, ds1)
    # the Pallas block algebra on one (batch, head): its ds recomputes
    # delta from the same dO and O
    sm_scale = 1.0 / math.sqrt(16)
    valid = jnp.asarray(np.tril(np.ones((40, 40), bool)))
    for b, h in ((0, 0), (1, 1)):
        blk = [jnp.asarray(t[b, :, h].float().numpy())
               for t in (q, k, v, dout, out)]
        _, want = _bwd_block(*blk, jnp.asarray(lse[b, h].numpy()), sm_scale,
                             valid)
        np.testing.assert_allclose(ds1[b, h].numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(
            delta[b, h].numpy(),
            np.sum(blk[3] * blk[4], axis=-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, sq, sk, d", [SHAPES[0], SHAPES[2]])
def test_wrappers_give_one_result_with_and_without_a_precomputed_delta(
        dtype, causal, sq, sk, d):
    """bf16: one result with and without the pre-pass's delta.  float32
    (whose kernels take delta from out): the pre-pass and ``delta=``
    raise, and the wrappers give the twins' result."""
    res = residuals(causal, sq, sk, d, dtype=dtype)
    q, k, v, out, lse, dout = res
    without = (flash_backward_dq(*res, causal), *flash_backward_dkdv(*res, causal))
    if dtype == torch.bfloat16:
        delta = flash_backward_delta(out, dout)
        assert torch.equal(delta, flash_backward_delta_plain(out, dout))
        with_delta = (flash_backward_dq(*res, causal, delta),
                      *flash_backward_dkdv(*res, causal, delta))
        for a, b in zip(without, with_delta):
            assert a.dtype == dtype and torch.equal(a, b)
    else:
        delta = flash_backward_delta_plain(out, dout)
        with pytest.raises(ValueError, match="bfloat16"):
            flash_backward_delta(out, dout)
        for fn in (flash_backward_dq, flash_backward_dkdv):
            with pytest.raises(ValueError, match="delta= is for the bf16"):
                fn(*res, causal, delta)
    for a, b in zip(without, grads(*res, causal)):
        assert a.dtype == dtype and torch.equal(a, b)


def test_unaligned_operands_are_copied_and_aligned_ones_pass_through():
    """The bf16 wrappers hand the kernels 16-byte aligned data: a
    contiguous view at an odd element offset is copied (same values), an
    aligned tensor passes as itself."""
    base = torch.arange(1 + 2 * 8 * 2 * 16, dtype=torch.float32).to(
        torch.bfloat16)
    view = base[1:].view(2, 8, 2, 16)
    assert view.is_contiguous() and view.data_ptr() % 16
    staged = _aligned(view)
    assert staged.data_ptr() % 16 == 0 and torch.equal(staged, view)
    whole = view.clone()
    assert _aligned(whole) is whole


def test_emulation_shares_are_zero_on_the_emulation_and_scale_with_error():
    q, k, v, out, lse, dout = residuals(True, 100, 100, 40)
    emu = grads(q, k, v, out, lse, dout, True, operand_dtype=torch.bfloat16)
    for e in emu:
        assert bf16_emulation_shares(e, e) == (0.0, 0.0)
        # one bf16 step on every element is within both allowances
        step = (e.float() * (1 + 2 ** -8)).to(torch.bfloat16)
        element, block = bf16_emulation_shares(step, e)
        assert 0.0 < element <= 1.0 and 0.0 < block <= 1.0
        # 2% off everywhere fails the block gate
        wrong = (e.float() * 1.02).to(torch.bfloat16)
        assert bf16_emulation_shares(wrong, e)[1] > 1.0


@pytest.mark.parametrize("grad", ["dk", "dv", "dq"])
def test_emulation_gate_catches_a_kernel_that_drops_one_q_tile(grad):
    """A K4 or K5 that skipped one 64-row q tile of the last K/V block
    (causal, where that block's sums are short and its gradients small)
    fails the block gate against the emulation."""
    causal, s, d = True, 256, 64
    q, k, v, out, lse, dout = residuals(causal, s, s, d)
    p, ds = _backward_probs(q, k, v, out, lse, dout, causal)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    tile = slice(192, 256)  # q rows, and the keys of the last block
    drop = torch.zeros_like(p)
    drop[:, :, tile, tile] = 1.0
    if grad == "dv":
        want = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
        bad = torch.einsum("bhqk,bqhd->bkhd", p * (1 - drop), dout.float())
    elif grad == "dk":
        want = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
        bad = torch.einsum("bhqk,bqhd->bkhd", ds * (1 - drop), q.float())
    else:
        want = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
        bad = torch.einsum("bhqk,bkhd->bqhd", ds * (1 - drop), k.float())
    emu = want.to(torch.bfloat16)
    assert bf16_emulation_shares(bad.to(torch.bfloat16), emu)[1] > 1.0


def test_bf16_autograd_backward_on_the_cpu_is_the_f32_twins():
    """On CPU tensors the autograd.Function's bf16 backward computes delta
    once and hands it to the twins, which keep the float32 algebra."""
    causal = True
    q, k, v, out, lse, dout = residuals(causal, 48, 48, 16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got_out = flash_attention(*leaves, causal)
    assert torch.equal(got_out, out)
    got_out.backward(dout)
    for g, w in zip((t.grad for t in leaves), grads(q, k, v, out, lse, dout,
                                                    causal)):
        assert torch.equal(g, w)
