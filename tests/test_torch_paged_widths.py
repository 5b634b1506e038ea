"""The paged kernels' shapes beyond the flagship's: every head width the
reference serves (a multiple of 8 up to 128) and any verify window.

The wrappers' checks take every such width and window, with and without
int8 scales.  The plain twins of K1 and K2 (K1q and K2q over an int8
pool) match the Pallas kernels (interpret mode off the TPU) at the JAX
worker's default head width (64), at the narrowest (8) and with a 9-row
window, at the reference's own tolerance of 2e-5 (tests/test_paging.py);
K2's row j equals K1 at ``lengths + j`` bit for bit.  The Hopper kernels
themselves are held against the twins at these widths on a card, in
tests/test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubegpu_tpu.ops.paged_attention import (
    paged_chunk_attention as jax_paged_chunk_attention,
    paged_decode_attention as jax_paged_decode_attention,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    MAX_HEAD_DIM,
    MAX_KERNEL_PAGE,
    check_chunk_args,
    check_kernel_args,
    paged_chunk_attention_plain,
    paged_decode_attention_plain,
    quantize_pages,
)
from test_torch_cuda_kernels import F32_TOL, make_chunk_case


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_functions_take_every_width_and_window(dtype, quant):
    """check_kernel_args and check_chunk_args take every multiple of 8 up
    to 128, and check_chunk_args windows of 1, 9 and 17 rows."""
    widths = range(8, MAX_HEAD_DIM + 1, 8)
    assert list(widths)[-1] == 128 and len(widths) == 16
    for hd in widths:
        pool_dtype = torch.int8 if quant else dtype
        pool = torch.zeros((3, 4, 16, hd), dtype=pool_dtype)
        scales = (torch.zeros((3, 4)),) * 2 if quant else ()
        table = torch.zeros((2, 2), dtype=torch.int32)
        lengths = torch.ones((2,), dtype=torch.int32)
        check_kernel_args(torch.zeros((2, 4, hd), dtype=dtype), pool, pool,
                          table, lengths, *scales)
        for rows in (1, 9, 17):
            check_chunk_args(torch.zeros((2, rows, 4, hd), dtype=dtype), pool,
                             pool, table, lengths, *scales)


@pytest.mark.parametrize("hd", [4, 12, 124, 136])
def test_check_functions_refuse_widths_off_the_rule(hd):
    pool = torch.zeros((3, 4, 16, hd))
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        check_kernel_args(torch.zeros((2, 4, hd)), pool, pool, table, lengths)
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        check_chunk_args(torch.zeros((2, 9, 4, hd)), pool, pool, table,
                         lengths)


def test_page_limit_is_the_cards_shared_memory():
    """A page's f32 scores, 32 floats of reductions and K2's least ring
    (two tiles of one 16-byte copy a thread: 1024 floats) fill at most the
    232,448 bytes an H100 block opts in to; the limit takes pages far past
    the old 4096 rows and refuses one more."""
    assert MAX_KERNEL_PAGE == 232448 // 4 - 32 - 8 * 128 == 57056
    q = torch.zeros((1, 1, 2, 64))
    table = torch.zeros((1, 1), dtype=torch.int32)
    lengths = torch.ones((1,), dtype=torch.int32)
    for page, ok in ((4097, True), (MAX_KERNEL_PAGE, True),
                     (MAX_KERNEL_PAGE + 1, False)):
        pool = torch.zeros((1, 2, page, 64))
        if ok:
            check_chunk_args(q, pool, pool, table, lengths)
        else:
            with pytest.raises(ValueError, match="opt-in shared memory"):
                check_chunk_args(q, pool, pool, table, lengths)


def jax_run(fn, q, pools, table, lengths, scales):
    kw = {}
    if scales:
        kw = dict(k_scale=jnp.asarray(scales[0].numpy()),
                  v_scale=jnp.asarray(scales[1].numpy()))
    return np.asarray(fn(jnp.asarray(q), *(jnp.asarray(p.numpy())
                                            for p in pools),
                         jnp.asarray(table), jnp.asarray(lengths), **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("hd", [64, 8])
def test_twins_match_the_pallas_kernels_at_reference_widths(hd, quant):
    """K1 (K1q) and a 9-row K2 (K2q) window through the plain twins and
    the Pallas kernels on one numpy-seeded input: 4 heads of ``hd``,
    pages of 16, shuffled tables, lengths whose windows cross pages and
    reach the full table (47 + 8 = 55 of 64 rows).  f32 at 2e-5."""
    L = 9
    q, kp, vp, table, lengths = make_chunk_case(
        50 + hd, [0, 1, 15, 16, 33, 47], L, h=4, hd=hd, page=16, n_pages=4,
        pool=26)
    if quant:
        (kd, ks), (vd, vs) = (quantize_pages(torch.from_numpy(a))
                              for a in (kp, vp))
        pools, scales = (kd, vd), (ks, vs)
    else:
        pools, scales = (torch.from_numpy(kp), torch.from_numpy(vp)), ()
    qt = torch.from_numpy(q)
    tbl, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    one = paged_decode_attention_plain(qt[:, 0].contiguous(), *pools, tbl, ln,
                                       *scales)
    np.testing.assert_allclose(
        one.numpy(), jax_run(jax_paged_decode_attention, q[:, 0], pools,
                             table, lengths, scales),
        rtol=F32_TOL, atol=F32_TOL)
    out = paged_chunk_attention_plain(qt, *pools, tbl, ln, *scales)
    np.testing.assert_allclose(
        out.numpy(), jax_run(jax_paged_chunk_attention, q, pools, table,
                             lengths, scales),
        rtol=F32_TOL, atol=F32_TOL)
    assert (out[0, 0] == 0).all() and (out[1:, -1] != 0).any()
    for j in range(L):
        assert torch.equal(out[:, j], paged_decode_attention_plain(
            qt[:, j].contiguous(), *pools, tbl, ln + j, *scales)), j
