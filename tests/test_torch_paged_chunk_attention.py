"""The port's multi-query paged attention (K2, kubegpu_tpu_torch/ops)
against the JAX package's: the plain twin and the dense oracle against
the Pallas ``paged_chunk_attention`` (interpret mode off the TPU) and
``reference_paged_chunk_attention``, at small widths (4 heads of 32,
8-row pages) with shuffled tables.  Plain K2 row j must equal plain K1
at ``lengths + j`` bit for bit.  The Hopper kernel itself is held
against the twin on a card, in tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubegpu_tpu.ops.paged_attention import (
    paged_chunk_attention as jax_paged_chunk_attention,
    reference_paged_chunk_attention as jax_reference_paged_chunk_attention,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    check_chunk_args,
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_decode_attention_plain,
    reference_paged_attention,
    reference_paged_chunk_attention,
)
from test_torch_cuda_kernels import (
    BF16_ATOL,
    BF16_RTOL,
    F32_TOL,
    make_chunk_case,
    run_torch,
)
from test_torch_paged_attention import run_jax

# 4 pages of 8 rows: length 6 sends a 5-row window across the first page
# boundary, 8 starts it on one, 28 makes the widest row reach the full
# table (28 + 4 = 32 rows)
CROSSING = [1, 6, 8, 28]


@pytest.mark.parametrize("lengths, L", [
    (CROSSING, 5),
    ([3, 7, 15, 16], 3),
    ([0, 2, 9, 30], 2),
], ids=["L5-crossing", "L3-near-boundary", "L2-zero-length"])
def test_plain_twin_and_oracle_match_jax_kernel_and_reference(lengths, L):
    """Mirror of tests/test_paging.py's chunk-kernel test at small
    widths."""
    case = make_chunk_case(0, lengths, L)
    jax_kernel = run_jax(jax_paged_chunk_attention, case)
    jax_ref = np.nan_to_num(run_jax(jax_reference_paged_chunk_attention, case))
    plain = run_torch(paged_chunk_attention_plain, case)
    dense = run_torch(reference_paged_chunk_attention, case)
    assert plain.shape == case[0].shape
    np.testing.assert_allclose(plain, jax_kernel, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(plain, jax_ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(dense, jax_ref, rtol=F32_TOL, atol=F32_TOL)


def test_row_with_nothing_to_attend_gives_zeros_like_the_jax_kernel():
    case = make_chunk_case(1, [0, 5, 12, 20], 3)
    jax_kernel = run_jax(jax_paged_chunk_attention, case)
    plain = run_torch(paged_chunk_attention_plain, case)
    dense = run_torch(reference_paged_chunk_attention, case)
    assert (plain[0, 0] == 0).all() and (dense[0, 0] == 0).all()
    assert (jax_kernel[0, 0] == 0).all()
    assert (plain[0, 1] != 0).any()  # row 1 attends one column
    np.testing.assert_allclose(plain, jax_kernel, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_pool_matches_jax_kernel():
    case = make_chunk_case(2, CROSSING, 5)
    jax_kernel = run_jax(jax_paged_chunk_attention, case, jnp.bfloat16)
    plain = run_torch(paged_chunk_attention_plain, case, torch.bfloat16)
    np.testing.assert_allclose(plain, jax_kernel, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [1, 3, 5])
def test_plain_rows_bit_match_the_decode_twin(dtype, L):
    """Row j of the window is plain K1 at lengths + j, bit for bit (L=1
    is the degenerate window: plain K1 itself)."""
    q, kp, vp, table, lengths = make_chunk_case(3, CROSSING, L)
    args = [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
    tbl, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    out = paged_chunk_attention_plain(*args, tbl, ln)
    assert out.dtype == dtype
    for j in range(L):
        single = paged_decode_attention_plain(args[0][:, j], *args[1:], tbl,
                                              ln + j)
        assert torch.equal(out[:, j], single), f"window row {j} diverged"


def test_oracle_rows_match_the_decode_oracle():
    q, kp, vp, table, lengths = make_chunk_case(4, CROSSING, 4)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    tbl, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    out = reference_paged_chunk_attention(*args, tbl, ln)
    for j in range(4):
        torch.testing.assert_close(
            out[:, j], reference_paged_attention(args[0][:, j], *args[1:],
                                                 tbl, ln + j),
            rtol=F32_TOL, atol=F32_TOL)


def test_cpu_tensors_take_the_plain_twin_without_a_launch():
    case = make_chunk_case(5, CROSSING, 5)
    before = paged_chunk_attention.launches
    out = run_torch(paged_chunk_attention, case)
    assert paged_chunk_attention.launches == before
    np.testing.assert_array_equal(
        out, run_torch(paged_chunk_attention_plain, case))


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(hd=136), "head_dim"),
    (dict(table_dtype=torch.int64), "int32"),
    (dict(pool_heads=4), "heads/width"),
    (dict(rows=0), "query rows"),
    (dict(q_dims=3), r"\(b, L, h, hd\)"),
    (dict(transposed=True), "contiguous"),
])
def test_chunk_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    dtype = bad.get("dtype", torch.float32)
    hd = bad.get("hd", 128)
    h, rows = 8, bad.get("rows", 3)
    q = torch.zeros((2, rows, h, hd), dtype=dtype)
    if bad.get("q_dims") == 3:
        q = q[:, 0]
    if bad.get("transposed"):
        q = torch.zeros((2, h, rows, hd), dtype=dtype).transpose(1, 2)
    pool = torch.zeros((3, bad.get("pool_heads", h), 16, hd), dtype=dtype)
    table = torch.zeros((2, 2), dtype=bad.get("table_dtype", torch.int32))
    lengths = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        check_chunk_args(q, pool, pool, table, lengths)


def test_chunk_wrapper_takes_the_verify_layout():
    q = torch.zeros((2, 5, 8, 128), dtype=torch.bfloat16)
    pool = torch.zeros((3, 8, 16, 128), dtype=torch.bfloat16)
    check_chunk_args(q, pool, pool, torch.zeros((2, 2), dtype=torch.int32),
                     torch.ones((2,), dtype=torch.int32))
