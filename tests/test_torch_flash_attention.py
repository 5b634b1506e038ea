"""The port's flash attention (kubegpu_tpu_torch/ops/attention.py) against
the JAX package's: the plain twins of K3 (forward), K4 (dK, dV) and K5
(dQ) and the autograd.Function that joins them, given the same
numpy-seeded inputs as the Pallas kernels (interpret mode off the TPU,
blocks of 32 as in tests/test_ops.py).

Tolerances: float32 out and lse rtol=atol=2e-5 and gradients 1e-4, the
reference's own (tests/test_ops.py); bfloat16 one rounding step (rtol
2^-7, atol 1e-5), since both sides compute in float32 and round once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.attention import (
    _flash_backward,
    _flash_forward,
    _lse_pack,
    _lse_unpack,
    flash_attention as jax_flash_attention,
    reference_attention as jax_reference_attention,
)
from kubegpu_tpu_torch.ops.attention import (
    check_flash_args,
    flash_attention,
    flash_backward_dkdv,
    flash_backward_dkdv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward,
    flash_forward_plain,
    reference_attention,
)

F32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_RTOL = 2 ** -7
BF16_ATOL = 1e-5
BLOCK = 32


def qkv(sq=64, sk=None, b=2, h=2, d=32, seed=0):
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


def to_torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for a in arrays]


def to_np(t):
    return t.detach().float().numpy()


def jax_forward(q, k, v, causal, dtype=jnp.float32):
    """The Pallas forward's out and its lse as dense (b, h, sq)."""
    b, sq, h, _ = q.shape
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    out, packed = jax.jit(lambda q, k, v: _flash_forward(
        q, k, v, causal, BLOCK, BLOCK, None))(qj, kj, vj)
    sqp = packed.shape[1] * packed.shape[3]
    lse = _lse_unpack(packed, b, h, sqp, packed.shape[3])[:, :sq]
    return out, np.asarray(lse).transpose(0, 2, 1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 100])
def test_forward_twin_and_function_match_the_pallas_kernel(causal, s):
    q, k, v = qkv(s)
    want, want_lse = jax_forward(q, k, v, causal)
    tq, tk, tv = to_torch(q, k, v)
    out, lse = flash_forward_plain(tq, tk, tv, causal)
    assert out.dtype == torch.float32 and lse.shape == (2, 2, s)
    np.testing.assert_allclose(to_np(out), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=F32_TOL,
                               atol=F32_TOL)
    # the CPU wrapper is the twin, and the autograd.Function its forward
    wrapped, wrapped_lse = flash_forward(tq, tk, tv, causal)
    assert torch.equal(wrapped, out) and torch.equal(wrapped_lse, lse)
    assert torch.equal(flash_attention(tq, tk, tv, causal), out)


@pytest.mark.parametrize("causal, sq, sk", [(True, 48, 48), (False, 40, 56)])
def test_reference_attention_matches_the_jax_oracle(causal, sq, sk):
    q, k, v = qkv(sq, sk, seed=3)
    want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    got = reference_attention(*to_torch(q, k, v), causal)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal, sq, sk", [(True, 64, 64), (False, 40, 56)])
def test_gradients_match_jax_grad(causal, sq, sk):
    """dq, dk, dv of sum(out^2) through the autograd.Function against
    jax.grad of the Pallas flash_attention (padded rows and columns, in
    the 40 x 56 case, must contribute exactly zero)."""
    q, k, v = qkv(sq, sk, seed=1)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, BLOCK, BLOCK) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in to_torch(q, k, v))
    (flash_attention(tq, tk, tv, causal) ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def jax_backward(q, k, v, out, lse, dout, causal, dtype=jnp.float32):
    """The Pallas backward kernels on the given residuals (lse dense
    (b, h, sq), sq a multiple of BLOCK)."""
    packed = _lse_pack(jnp.asarray(lse).transpose(0, 2, 1), BLOCK)
    args = [jnp.asarray(a, dtype) for a in (q, k, v, out)]
    return jax.jit(lambda q, k, v, o, p, g: _flash_backward(
        q, k, v, o, p, g, causal, BLOCK, BLOCK, None))(
            *args, packed, jnp.asarray(dout, dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_backward_twins_match_the_pallas_kernels_with_empty_rows(causal):
    """K4's and K5's twins against the Pallas backward on the same
    residuals, where some rows' lse is -inf and their out 0 (the
    forward's answer for a row with nothing to attend, as a ring step
    whose K/V block lies wholly in the future produces): those rows'
    p is 0, so they add nothing to dk, dv and get dq 0."""
    q, k, v = qkv(64, seed=2)
    out, lse = jax_forward(q, k, v, causal)
    out = np.array(out)
    lse = np.array(lse)
    empty = [0, 5, 33]
    lse[:, :, empty] = -np.inf
    out[:, empty] = 0.0
    dout = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    want_dq, want_dk, want_dv = jax_backward(q, k, v, out, lse, dout, causal)
    tq, tk, tv, to, tdo = to_torch(q, k, v, out, dout)
    tl = torch.from_numpy(lse)
    dk, dv = flash_backward_dkdv_plain(tq, tk, tv, to, tl, tdo, causal)
    dq = flash_backward_dq_plain(tq, tk, tv, to, tl, tdo, causal)
    for got, ref in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    assert (dq[:, empty] == 0).all()
    # the CPU wrappers are the twins
    assert all(torch.equal(a, b) for a, b in zip(
        flash_backward_dkdv(tq, tk, tv, to, tl, tdo, causal), (dk, dv)))
    assert torch.equal(flash_backward_dq(tq, tk, tv, to, tl, tdo, causal), dq)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_the_pallas_kernel_within_one_rounding_step(causal):
    """bfloat16 inputs: the forward's out (and its float32 lse), then the
    backward on the JAX forward's residuals, so both sides read the same
    bf16 operands, compute in float32 and round once."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in qkv(64, seed=4))
    want, want_lse = jax_forward(q, k, v, causal, jnp.bfloat16)
    tq, tk, tv = to_torch(q, k, v, dtype=torch.bfloat16)
    out, lse = flash_forward_plain(tq, tk, tv, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=F32_TOL,
                               atol=F32_TOL)
    out_np = np.asarray(want, np.float32)
    dout = np.asarray(jnp.asarray(
        np.random.RandomState(8).randn(*q.shape), jnp.bfloat16)
        .astype(jnp.float32))
    want_grads = jax_backward(q, k, v, out_np, want_lse, dout, causal,
                              jnp.bfloat16)
    to, tdo = to_torch(out_np, dout, dtype=torch.bfloat16)
    tl = torch.from_numpy(np.ascontiguousarray(want_lse))
    dk, dv = flash_backward_dkdv_plain(tq, tk, tv, to, tl, tdo, causal)
    dq = flash_backward_dq_plain(tq, tk, tv, to, tl, tdo, causal)
    for got, ref in zip((dq, dk, dv), want_grads):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(got), np.asarray(ref, np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


def test_causal_with_unequal_lengths_raises_like_jax():
    q, _, _ = qkv(64)
    _, k, v = qkv(128)
    with pytest.raises(ValueError, match="causal"):
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, BLOCK, BLOCK)
    tq, tk, tv = to_torch(q, k, v)
    for fn in (flash_attention, flash_forward, flash_forward_plain):
        with pytest.raises(ValueError, match="causal.*sq == sk"):
            fn(tq, tk, tv, True)


def test_saved_tensors_hold_no_score_matrix():
    """The forward saves q, k, v, out and the lse — O(s) each — and no
    (s, s) tensor, as the JAX custom_vjp's residuals."""
    s = 256
    tq, tk, tv = (t.requires_grad_() for t in to_torch(*qkv(s, h=1, d=16)))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention(tq, tk, tv, True)
    assert sorted(saved) == sorted([(2, s, 1, 16)] * 4 + [(2, 1, s)])
    assert not any(len(sh) >= 2 and sh[-1] == s and sh[-2] == s
                   for sh in saved)
    out.sum().backward()
    assert tq.grad.shape == tq.shape


@pytest.mark.parametrize("bad, match", [
    (dict(d=12), "multiple of 8"),
    (dict(d=136), "multiple of 8"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(k_heads=3), "differ"),
    (dict(sq=48), "causal"),
])
def test_check_flash_args_refuses_what_the_kernels_do_not_take(bad, match):
    d = bad.get("d", 16)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros((1, bad.get("sq", 32), 2, d), dtype=dtype)
    k = torch.zeros((1, 32, bad.get("k_heads", 2), d), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        check_flash_args(q, k, k.clone(), True)


def test_check_flash_args_takes_every_kernel_width():
    for d in range(8, 129, 8):
        q = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16)
        check_flash_args(q, q.clone(), q.clone(), True)
