"""The port's paged decode attention (kubegpu_tpu_torch/ops) against the
JAX package's: the plain twin and the dense oracle against the Pallas
kernel (interpret mode off the TPU) and its reference.  The Hopper
kernel itself is held against the plain twin on a card, in
tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubegpu_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
    reference_paged_attention as jax_reference_paged_attention,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    check_kernel_args,
    paged_decode_attention,
    paged_decode_attention_plain,
    reference_paged_attention,
)
from test_torch_cuda_kernels import (
    BF16_ATOL,
    BF16_RTOL,
    F32_TOL,
    make_case,
    run_torch,
)


def run_jax(fn, case, dtype=jnp.float32):
    q, kp, vp, table, lengths = case
    out = fn(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
             jnp.asarray(vp, dtype), jnp.asarray(table), jnp.asarray(lengths))
    return np.asarray(out.astype(jnp.float32))


def test_plain_twin_matches_jax_kernel_and_reference():
    """Mirror of tests/test_paging.py's kernel test: lengths 1 (one row),
    200 (a partial page), 256 (page-aligned) and 512 (the full table)."""
    case = make_case(0, [1, 200, 256, 512])
    jax_kernel = run_jax(jax_paged_decode_attention, case)
    jax_ref = run_jax(jax_reference_paged_attention, case)
    plain = run_torch(paged_decode_attention_plain, case)
    dense = run_torch(reference_paged_attention, case)
    np.testing.assert_allclose(plain, jax_kernel, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(plain, jax_ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(dense, jax_ref, rtol=F32_TOL, atol=F32_TOL)


def test_length_zero_slot_gives_zeros_like_the_jax_kernel():
    case = make_case(1, [0, 130, 5, 384])
    jax_kernel = run_jax(jax_paged_decode_attention, case)
    plain = run_torch(paged_decode_attention_plain, case)
    assert (plain[0] == 0).all()
    assert (run_torch(reference_paged_attention, case)[0] == 0).all()
    np.testing.assert_allclose(plain, jax_kernel, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_pool_matches_jax_kernel():
    case = make_case(2, [3, 129, 300, 512])
    jax_kernel = run_jax(jax_paged_decode_attention, case, jnp.bfloat16)
    plain = run_torch(paged_decode_attention_plain, case, torch.bfloat16)
    np.testing.assert_allclose(plain, jax_kernel, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_small_pages_and_widths_match_jax_kernel():
    """The tiny serving config's geometry (page 4, head_dim 8)."""
    case = make_case(3, [1, 4, 9, 16], b=4, h=4, hd=8, page=4, n_pages=4,
                     pool=20)
    np.testing.assert_allclose(
        run_torch(paged_decode_attention_plain, case),
        run_jax(jax_paged_decode_attention, case),
        rtol=F32_TOL, atol=F32_TOL,
    )


def test_cpu_tensors_take_the_plain_twin_without_a_launch():
    case = make_case(4, [1, 200, 256, 512])
    before = paged_decode_attention.launches
    out = run_torch(paged_decode_attention, case)
    assert paged_decode_attention.launches == before
    np.testing.assert_array_equal(
        out, run_torch(paged_decode_attention_plain, case)
    )


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(hd=12), "head_dim"),
    (dict(table_dtype=torch.int64), "int32"),
    (dict(pool_heads=4), "heads/width"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    dtype = bad.get("dtype", torch.float32)
    hd = bad.get("hd", 128)
    h = 8
    q = torch.zeros((2, h, hd), dtype=dtype)
    pool = torch.zeros((3, bad.get("pool_heads", h), 16, hd), dtype=dtype)
    table = torch.zeros((2, 2), dtype=bad.get("table_dtype", torch.int32))
    lengths = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, pool, pool, table, lengths)
