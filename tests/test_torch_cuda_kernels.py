"""The port's hand-written CUDA kernels (K1, K2 and their int8-scale
variants K1q, K2q, at every head width and window they take; flash
attention K3, K4, K5 and the backward's delta pre-pass) against their
plain PyTorch twins, on a card only (``-m cuda``; they skip without a
CUDA device).

This file imports no JAX, so it also runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Its input helpers are shared with the CPU parity tests of
tests/test_torch_paged_attention.py."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.ops.attention import (
    bf16_emulation_shares,
    bf16_gradient_allowance,
    flash_attention,
    flash_backward_delta,
    flash_backward_delta_plain,
    flash_backward_dkdv,
    flash_backward_dkdv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward,
    flash_forward_plain,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    MAX_KERNEL_PAGE,
    chunk_plan,
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_split_attention_plain,
    quantize_pages,
    split_plan,
)

# the reference's own kernel tolerance (tests/test_paging.py)
F32_TOL = 2e-5
# flash gradients in float32: the reference's (tests/test_ops.py)
GRAD_TOL = 1e-4
# bfloat16: both sides compute in f32 and round once to bf16, so they
# may differ by one bf16 rounding step (at most 2^-7 of the value); the
# small atol covers outputs near zero, where f32 noise outgrows a step
BF16_RTOL = 2 ** -7
BF16_ATOL = 1e-5


def make_case(seed, lengths, b=4, h=8, hd=128, page=128, n_pages=4, pool=16):
    """Shuffled page tables and ragged lengths, as tests/test_paging.py
    builds them."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    kp = (rng.randn(pool, h, page, hd) * 0.3).astype(np.float32)
    vp = (rng.randn(pool, h, page, hd) * 0.3).astype(np.float32)
    table = np.stack(
        [rng.choice(pool, n_pages, replace=False) for _ in range(b)]
    ).astype(np.int32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def make_chunk_case(seed, lengths, L, b=None, h=4, hd=32, page=8,
                    n_pages=4, pool=12):
    """The multi-query kernel's inputs: q ``(b, L, h, hd)``, otherwise as
    :func:`make_case`."""
    b = len(lengths) if b is None else b
    rng = np.random.RandomState(seed)
    q = rng.randn(b, L, h, hd).astype(np.float32)
    _, kp, vp, table, lengths = make_case(seed + 1000, lengths, b=b, h=h,
                                          hd=hd, page=page, n_pages=n_pages,
                                          pool=pool)
    return q, kp, vp, table, lengths


def split_edge(page, hd, dtype, quant):
    """Rows of a split of the kernels' plan: the first split edge."""
    return split_plan(page, hd, dtype, quant)[0] * page


def run_torch(fn, case, dtype=torch.float32, device="cpu"):
    q, kp, vp, table, lengths = case
    args = [torch.from_numpy(a).to(device) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args]
    args += [torch.from_numpy(table).to(device),
             torch.from_numpy(lengths).to(device)]
    return fn(*args).float().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_kernel_matches_plain_twin_on_the_card(cuda_device, dtype, rtol,
                                               atol):
    case = make_case(5, [0, 1, 127, 128, 200, 512], b=6, h=32, n_pages=4,
                     pool=30)
    before = paged_decode_attention.launches
    out = run_torch(paged_decode_attention, case, dtype, cuda_device)
    assert paged_decode_attention.launches == before + 1
    plain = run_torch(paged_decode_attention_plain, case, dtype, cuda_device)
    np.testing.assert_allclose(out, plain, rtol=rtol, atol=atol)
    assert (out[0] == 0).all()


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_cuda_tensors_it_cannot_take(cuda_device):
    case = make_case(6, [3, 9], b=2, h=4, hd=12, page=4, n_pages=3, pool=8)
    with pytest.raises(ValueError, match="head_dim"):
        run_torch(paged_decode_attention, case, torch.float32, cuda_device)


def paged_operands(case, dtype, device, quant):
    """A chunk case on the card: q in ``dtype``; pools in ``dtype``, or
    int8 from :func:`quantize_pages` with their scales (as kwargs)."""
    q, kp, vp, table, lengths = case
    qt = torch.from_numpy(q).to(device, dtype)
    if quant:
        (kd, ks), (vd, vs) = (quantize_pages(torch.from_numpy(a))
                              for a in (kp, vp))
        pools = [kd.to(device), vd.to(device)]
        scales = dict(k_scale=ks.to(device), v_scale=vs.to(device))
    else:
        pools = [torch.from_numpy(a).to(device, dtype) for a in (kp, vp)]
        scales = {}
    return (qt, *pools, torch.from_numpy(table).to(device),
            torch.from_numpy(lengths).to(device)), scales


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("hd", [8, 16, 40, 64, 128])
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_paged_kernels_match_their_twins_at_every_width(cuda_device, dtype,
                                                        rtol, atol, hd,
                                                        quant):
    """K1 and K2 (K1q and K2q over an int8 pool) against their plain
    twins at the exact widths (64, 128) and padded ones (8, 16, 40), with
    a 9-row window (two groups of rows); f32 at the reference's 2e-5,
    bf16 within one rounding step.  K2's rows equal K1 at lengths + j."""
    L = 9
    edge = split_edge(32, hd, dtype, quant)
    case = make_chunk_case(21 + hd, [0, 1, 5, 31, 32, 33, 100, edge - 4], L,
                           h=4, hd=hd, page=32, n_pages=edge // 32 + 2,
                           pool=edge // 32 + 20)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, dtype, cuda_device, quant)
    one = paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, ln, **sc)
    out = paged_chunk_attention(q, kp, vp, tbl, ln, **sc)
    want_one = paged_decode_attention_plain(q[:, 0].contiguous(), kp, vp,
                                            tbl, ln, **sc)
    want = paged_chunk_attention_plain(q, kp, vp, tbl, ln, **sc)
    assert one.shape == want_one.shape and out.shape == q.shape
    torch.testing.assert_close(one.float(), want_one.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert (one[0] == 0).all() and (out[0, 0] == 0).all()
    for j in range(L):
        assert torch.equal(out[:, j], paged_decode_attention(
            q[:, j].contiguous(), kp, vp, tbl, ln + j, **sc)), j


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("L", [1, 5, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_rows_equal_k1_for_any_window(cuda_device, dtype, L, quant):
    """Row j of a K2 (K2q) window of L rows equals K1 (K1q) at lengths + j
    bit for bit, for windows inside one group of rows and across two or
    three, at the worker's default head width (64) and pages of 16, with
    windows that straddle the first and second split edges."""
    edge = split_edge(16, 64, dtype, quant)
    case = make_chunk_case(31 + L, [0, 1, 15, 16, 17, 40, 47, edge - L + 2,
                                    edge - 1, 2 * edge - L // 2], L, h=4,
                           hd=64, page=16, n_pages=2 * edge // 16 + 2,
                           pool=2 * edge // 16 + 10)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, dtype, cuda_device, quant)
    out = paged_chunk_attention(q, kp, vp, tbl, ln, **sc)
    for j in range(L):
        assert torch.equal(out[:, j], paged_decode_attention(
            q[:, j].contiguous(), kp, vp, tbl, ln + j, **sc)), j


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_paged_kernels_take_a_page_beyond_4096_rows(cuda_device, dtype, rtol,
                                                    atol):
    """Pages of 5000 rows (their scores take 20 KB of shared memory, past
    the old 4096-row limit): K1 and K2 against their twins."""
    case = make_chunk_case(41, [0, 1, 4999, 5000, 7000, 9998], 3, h=2, hd=64,
                           page=5000, n_pages=2, pool=4)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, dtype, cuda_device, False)
    torch.testing.assert_close(
        paged_decode_attention(q[:, 0].contiguous(), kp, vp, tbl, ln).float(),
        paged_decode_attention_plain(q[:, 0].contiguous(), kp, vp, tbl,
                                     ln).float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(
        paged_chunk_attention(q, kp, vp, tbl, ln).float(),
        paged_chunk_attention_plain(q, kp, vp, tbl, ln).float(), rtol=rtol,
        atol=atol)


def assert_chunk_rows_are_k1(q, kp, vp, tbl, ln, sc, rtol, atol):
    """One K2 (K2q) launch: within tolerance of its plain twin, each row j
    equal to K1 (K1q) at lengths + j bit for bit; returns the result."""
    out = paged_chunk_attention(q, kp, vp, tbl, ln, **sc)
    torch.testing.assert_close(
        out.float(),
        paged_chunk_attention_plain(q, kp, vp, tbl, ln, **sc).float(),
        rtol=rtol, atol=atol)
    for j in range(q.shape[1]):
        assert torch.equal(out[:, j], paged_decode_attention(
            q[:, j].contiguous(), kp, vp, tbl, ln + j, **sc)), j
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("L", [9, 17])
@pytest.mark.parametrize("page", [20000, MAX_KERNEL_PAGE])
def test_chunk_rows_equal_k1_where_the_plan_walks_fewer_rows(cuda_device,
                                                           page, L):
    """f32 at hd 128 over pages so large that the plan folds fewer than 8
    rows a walk (2 at 20,000 rows, 1 at MAX_KERNEL_PAGE): windows of 9
    and 17 rows take several walks, and each row stays K1 at lengths + j;
    a length-0 slot's row 0 gives zeros."""
    assert chunk_plan(page, 128, torch.float32, False)[0] < 8
    case = make_chunk_case(51 + L, [0, 1, page - 3, page, 2 * page - L + 1],
                           L, h=1, hd=128, page=page, n_pages=2, pool=3)
    args, sc = paged_operands(case, torch.float32, cuda_device, False)
    out = assert_chunk_rows_are_k1(*args, sc, F32_TOL, F32_TOL)
    assert (out[0, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_chunk_rows_equal_k1_at_tile_edges(cuda_device, dtype, rtol, atol,
                                           quant):
    """Lengths one short of, at and one past a ring tile's edge, in the
    first page and the next, with a 5-row window whose rows cross them,
    and a length-0 slot: pages of 512 rows at hd 128, several tiles a
    page.  Row j equals K1 (K1q) at lengths + j; a length-0 slot's row 0
    gives zeros."""
    page = 512
    tile = chunk_plan(page, 128, dtype, quant)[1]
    assert tile < page
    # page - 2: a window across the page's edge, which is a split's
    lengths = [0, tile - 1, tile, tile + 1, page - 2, page + tile - 1,
               page + tile, page + tile + 1]
    case = make_chunk_case(61, lengths, 5, h=2, hd=128, page=page, n_pages=3,
                           pool=24)
    args, sc = paged_operands(case, dtype, cuda_device, quant)
    out = assert_chunk_rows_are_k1(*args, sc, rtol, atol)
    assert (out[0, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_chunk_kernel_is_deterministic(cuda_device, quant):
    """Two launches on the same inputs give the same bits (no atomics, no
    order that depends on timing)."""
    case = make_chunk_case(71, [0, 1, 127, 128, 300, 508], 5, h=8, hd=128,
                           page=128, n_pages=4, pool=30)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, torch.bfloat16,
                                              cuda_device, quant)
    first = paged_chunk_attention(q, kp, vp, tbl, ln, **sc)
    assert torch.equal(first, paged_chunk_attention(q, kp, vp, tbl, ln, **sc))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 4, 32], ids=["hd128", "hd64", "hd8"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_batcher_on_the_card_matches_the_cpu_at_fp32(cuda_device, pipeline,
                                                     heads):
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=97, num_layers=2, num_heads=heads, hidden=256,
               max_seq=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 97, size=12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 97, size=n)])
               .astype(np.int32) for n in (3, 8, 1, 5, 11)]
    budgets = [20, 9, 15, 30, 12]
    kw = dict(cfg, slots=2, prompt_pad=24, page_size=8, pool_pages=14,
              token_budget=12, dtype=torch.float32)
    cpu = PagedContinuousBatcher(params, device="cpu", **kw)
    card = PagedContinuousBatcher(params, device=cuda_device,
                                  pipeline_decode=pipeline, **kw)
    before = paged_decode_attention.launches
    got = card.run(prompts, budgets)
    assert paged_decode_attention.launches - before == (
        card.stats["steps"] * cfg["num_layers"])
    assert got == cpu.run(prompts, budgets)
    assert card.stats["prefix_hit_tokens"] > 0
    card.assert_page_accounting()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_chunk_kernel_matches_its_twin_and_k1_row_by_row(cuda_device, dtype,
                                                        rtol, atol):
    """K2 within tolerance of its plain twin; its row j equal to K1 at
    lengths + j bit for bit (both fold through one device routine); a
    one-row window equal to K1; 253's window crosses a split edge."""
    L = 5
    assert split_edge(128, 128, dtype, False) == 256
    q, kp, vp, table, lengths = make_chunk_case(
        7, [0, 1, 124, 127, 128, 253, 300, 508], L, h=8, hd=128, page=128,
        n_pages=4, pool=30)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in (q, kp, vp)]
    tbl = torch.from_numpy(table).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    before = paged_chunk_attention.launches
    out = paged_chunk_attention(*args, tbl, ln)
    assert paged_chunk_attention.launches == before + 1
    plain = paged_chunk_attention_plain(*args, tbl, ln)
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)
    assert (out[0, 0] == 0).all()
    for j in range(L):
        single = paged_decode_attention(args[0][:, j].contiguous(),
                                        *args[1:], tbl, ln + j)
        assert torch.equal(out[:, j], single), f"window row {j} diverged"
    one = paged_chunk_attention(args[0][:, :1].contiguous(), *args[1:], tbl,
                                ln)
    assert torch.equal(one[:, 0], paged_decode_attention(
        args[0][:, 0].contiguous(), *args[1:], tbl, ln))


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False])
def test_spec_batcher_on_the_card_matches_the_plain_cpu_batcher(cuda_device,
                                                                pipeline):
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=97, num_layers=2, num_heads=2, hidden=256,
               max_seq=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, size=n).astype(np.int32)
               for n in (3, 17, 9, 24, 12)]
    budgets = [20, 9, 15, 30, 12]
    kw = dict(cfg, slots=2, prompt_pad=24, page_size=8, pool_pages=24,
              dtype=torch.float32)
    want = PagedContinuousBatcher(params, device="cpu", **kw).run(prompts,
                                                                  budgets)
    card = PagedContinuousBatcher(
        params, device=cuda_device, pipeline_decode=pipeline,
        draft_params=params, speculate_k=3, draft_num_layers=2,
        draft_num_heads=2, draft_hidden=256, **kw)
    before = (paged_decode_attention.launches,
              paged_chunk_attention.launches)
    got = card.run(prompts, budgets)
    assert paged_decode_attention.launches == before[0]
    assert paged_chunk_attention.launches - before[1] == (
        card.stats["spec_steps"] * cfg["num_layers"])
    assert got == want
    card.assert_page_accounting()


# the serving geometries of the split tests, at fewer heads: the
# flagship's (hd 128, pages of 128) and the worker's defaults' (hd 64,
# pages of 32)
SPLIT_GEOMETRIES = {"flagship": dict(h=4, hd=128, page=128),
                    "defaults": dict(h=8, hd=64, page=32)}


def split_case(seed, geo, dtype, quant, device, L=1, n_pages=64):
    """A 64-page table (several splits at either geometry), lengths 0, 1,
    either side of the first split edge and the full table; q (b, h, hd)
    for L = 1, else a window of L rows (lengths then leave it room)."""
    h, hd, page = geo["h"], geo["hd"], geo["page"]
    edge, full = split_edge(page, hd, dtype, quant), n_pages * page - L + 1
    lengths = [0, 1, page - 1, edge - 1, edge, edge + 1, 3 * edge + 5,
               full - 1, full]
    case = make_chunk_case(seed, lengths, L, h=h, hd=hd, page=page,
                           n_pages=n_pages, pool=n_pages + 8)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, dtype, device, quant)
    return (q[:, 0].contiguous() if L == 1 else q, kp, vp, tbl, ln), sc


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("geo", list(SPLIT_GEOMETRIES))
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_decode_kernels_match_their_twins_over_many_splits(
        cuda_device, dtype, rtol, atol, geo, quant):
    """K1 (K1q) over 64-page tables, several splits a slot, against the
    plain twin and the split-and-merge twin; a length-0 slot gives
    zeros."""
    args, sc = split_case(71, SPLIT_GEOMETRIES[geo], dtype, quant,
                          cuda_device)
    out = paged_decode_attention(*args, **sc)
    torch.testing.assert_close(
        out.float(), paged_decode_attention_plain(*args, **sc).float(),
        rtol=rtol, atol=atol)
    split = split_plan(args[1].shape[2], args[0].shape[-1], dtype, quant)[0]
    torch.testing.assert_close(
        out.float(), paged_split_attention_plain(
            *args, **sc, pages_per_split=split).float(), rtol=rtol, atol=atol)
    assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_decode_kernels_take_a_page_of_the_most_rows(cuda_device, quant):
    """K1 (K1q) at f32 over pages of MAX_KERNEL_PAGE rows, one page a
    split: against the twin, rows either side of the page (and split)
    edge."""
    page = MAX_KERNEL_PAGE
    case = make_chunk_case(72, [0, 1, page - 1, page, page + 1, 2 * page], 1,
                           h=1, hd=128, page=page, n_pages=2, pool=4)
    (q, kp, vp, tbl, ln), sc = paged_operands(case, torch.float32,
                                              cuda_device, quant)
    q = q[:, 0].contiguous()
    torch.testing.assert_close(
        paged_decode_attention(q, kp, vp, tbl, ln, **sc),
        paged_decode_attention_plain(q, kp, vp, tbl, ln, **sc),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("geo", list(SPLIT_GEOMETRIES))
def test_paged_kernels_are_batch_invariant_and_deterministic(cuda_device,
                                                             geo, quant):
    """K1 (K1q) and a 5-row K2 (K2q) window in bf16: two launches give
    the same bits, and each slot launched alone gives the bits it has in
    the batch (the split plan does not see the batch)."""
    for L in (1, 5):
        args, sc = split_case(73 + L, SPLIT_GEOMETRIES[geo], torch.bfloat16,
                              quant, cuda_device, L=L)
        fn = paged_decode_attention if L == 1 else paged_chunk_attention
        out = fn(*args, **sc)
        assert torch.equal(out, fn(*args, **sc))
        for i in range(out.shape[0]):
            q, kp, vp, tbl, ln = args
            alone = fn(q[i:i + 1].contiguous(), kp, vp,
                       tbl[i:i + 1].contiguous(), ln[i:i + 1].contiguous(),
                       **sc)
            assert torch.equal(alone[0], out[i]), (L, i)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_paged_kernels_replay_from_a_cuda_graph_with_new_lengths(cuda_device,
                                                                 quant):
    """K1 (K1q) and a 5-row K2 (K2q) window captured in a CUDA graph, then
    replayed after the lengths tensor is changed in place: each replay
    equals an eager call at the new lengths, so the launch reads no
    length on the host."""
    for L in (1, 5):
        args, sc = split_case(75 + L, SPLIT_GEOMETRIES["defaults"],
                              torch.bfloat16, quant, cuda_device, L=L)
        fn = paged_decode_attention if L == 1 else paged_chunk_attention
        ln = args[4]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args, **sc)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn(*args, **sc)
        full = int(ln.max())
        for new in (ln.flip(0), torch.clamp(ln + 37, max=full),
                    torch.zeros_like(ln)):
            ln.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(static, fn(*args, **sc)), (L, new.tolist())


def flash_case(device, dtype, causal, sq, sk, d, h=3, seed=None):
    rng = np.random.RandomState(sq + d if seed is None else seed)
    q, k, v = (torch.from_numpy(rng.randn(2, n, h, d).astype(np.float32))
               .to(device, dtype) for n in (sq, sk, sk))
    dout = torch.from_numpy(rng.randn(2, sq, h, d).astype(np.float32)).to(
        device, dtype)
    return q, k, v, dout


def assert_bf16_forward_passes_the_gate(out, lse, q, k, v, causal):
    """bf16 K3's out within ``bf16_gradient_allowance`` of the float32
    twin (fed the same bf16 values as float32): at most twice the error
    of the twin's bf16 emulation (p rounded before p . v), plus
    BF16_ATOL; within ``bf16_emulation_shares``'s allowances of the
    emulation itself, each element and each 64-row block; and lse within
    2e-5 of the float32 twin."""
    ref, ref_lse = flash_forward_plain(*(t.float() for t in (q, k, v)),
                                       causal)
    emu, _ = flash_forward_plain(q, k, v, causal,
                                 operand_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    err = (out.float() - ref).abs().max().item()
    emu_err = (emu.float() - ref).abs().max().item()
    assert err <= bf16_gradient_allowance(emu_err), (err, emu_err)
    element, block = bf16_emulation_shares(out, emu)
    assert element <= 1.0 and block <= 1.0, (element, block)
    torch.testing.assert_close(lse, ref_lse, rtol=F32_TOL, atol=F32_TOL)


def assert_bf16_gradients_pass_the_gate(got, q, k, v, out, lse, dout, causal):
    """dq, dk, dv of a bf16 kernel within ``bf16_gradient_allowance`` of
    the float32 twin (fed the same bf16 values as float32): at most twice
    the error of the twin's bf16 emulation, plus BF16_ATOL; and within
    ``bf16_emulation_shares``'s allowances of the emulation itself, each
    element and each 64-row block."""
    f32 = [t.float() for t in (q, k, v, out)]
    ref_dk, ref_dv = flash_backward_dkdv_plain(*f32, lse, dout.float(), causal)
    ref_dq = flash_backward_dq_plain(*f32, lse, dout.float(), causal)
    emu_dk, emu_dv = flash_backward_dkdv_plain(
        q, k, v, out, lse, dout, causal, operand_dtype=torch.bfloat16)
    emu_dq = flash_backward_dq_plain(q, k, v, out, lse, dout, causal,
                                     operand_dtype=torch.bfloat16)
    for name, g, emu, ref in zip(("dq", "dk", "dv"), got,
                                 (emu_dq, emu_dk, emu_dv),
                                 (ref_dq, ref_dk, ref_dv)):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        err = (g.float() - ref).abs().max().item()
        emu_err = (emu.float() - ref).abs().max().item()
        assert err <= bf16_gradient_allowance(emu_err), (name, err, emu_err)
        element, block = bf16_emulation_shares(g, emu)
        assert element <= 1.0 and block <= 1.0, (name, element, block)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, sq, sk, d, h", [
    (True, 200, 200, 128, 3), (True, 100, 100, 64, 3),
    (False, 72, 136, 40, 3), (True, 64, 64, 8, 3), (True, 1024, 1024, 128, 4),
])
def test_flash_kernels_match_their_twins(cuda_device, dtype, causal, sq, sk,
                                         d, h):
    """K3, K4 and K5 against the plain twins; the backward kernels read
    the twin forward's out and lse, so both sides see one set of
    operands.  f32: 2e-5 (out, lse), 1e-4 (gradients); bf16: out and the
    gradients within twice the error of the twins' bf16 emulation, and
    within its element and block allowances (the kernels round p and ds
    to bf16 for the tensor cores), lse 2e-5."""
    q, k, v, dout = flash_case(cuda_device, dtype, causal, sq, sk, d, h)
    bf16 = dtype == torch.bfloat16
    tol = dict(rtol=BF16_RTOL, atol=BF16_ATOL) if bf16 else dict(
        rtol=F32_TOL, atol=F32_TOL)
    before = (flash_forward.launches, flash_backward_dkdv.launches,
              flash_backward_dq.launches)
    out, lse = flash_forward(q, k, v, causal)
    p_out, p_lse = flash_forward_plain(q, k, v, causal)
    dk, dv = flash_backward_dkdv(q, k, v, p_out, p_lse, dout, causal)
    dq = flash_backward_dq(q, k, v, p_out, p_lse, dout, causal)
    assert (flash_forward.launches, flash_backward_dkdv.launches,
            flash_backward_dq.launches) == tuple(n + 1 for n in before)
    if bf16:
        assert_bf16_forward_passes_the_gate(out, lse, q, k, v, causal)
        assert_bf16_gradients_pass_the_gate((dq, dk, dv), q, k, v, p_out,
                                            p_lse, dout, causal)
        return
    torch.testing.assert_close(out.float(), p_out.float(), **tol)
    torch.testing.assert_close(lse, p_lse, rtol=F32_TOL, atol=F32_TOL)
    p_dk, p_dv = flash_backward_dkdv_plain(q, k, v, p_out, p_lse, dout,
                                           causal)
    p_dq = flash_backward_dq_plain(q, k, v, p_out, p_lse, dout, causal)
    for got, want in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal, sq, sk, d", [
    (True, 1000, 1000, 128), (False, 72, 136, 40),
])
def test_bf16_backward_kernels_are_deterministic(cuda_device, causal, sq, sk,
                                                 d):
    """One owner per gradient, no atomics: two launches on the same
    inputs are bit-identical, with and without a precomputed delta; the
    pre-pass matches its twin."""
    q, k, v, dout = flash_case(cuda_device, torch.bfloat16, causal, sq, sk, d)
    out, lse = flash_forward_plain(q, k, v, causal)
    delta = flash_backward_delta(out, dout)
    torch.testing.assert_close(delta, flash_backward_delta_plain(out, dout),
                               rtol=F32_TOL, atol=F32_TOL)
    runs = [(flash_backward_dq(q, k, v, out, lse, dout, causal, dl),
             *flash_backward_dkdv(q, k, v, out, lse, dout, causal, dl))
            for dl in (delta, delta, None)]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.mark.cuda
@pytest.mark.parametrize("causal, sq, sk, d, h", [
    (True, 1000, 1000, 128, 2), (False, 640, 1024, 128, 2),
    (False, 72, 136, 40, 3), (True, 200, 200, 64, 3),
])
def test_bf16_forward_kernel_passes_the_gates_and_is_deterministic(
        cuda_device, causal, sq, sk, d, h):
    """The tensor-core K3 in bf16: out through both emulation gates, lse
    within 2e-5 of the float32 twin, and two launches bit-identical."""
    q, k, v, _ = flash_case(cuda_device, torch.bfloat16, causal, sq, sk, d, h)
    out, lse = flash_forward(q, k, v, causal)
    assert_bf16_forward_passes_the_gate(out, lse, q, k, v, causal)
    again, again_lse = flash_forward(q, k, v, causal)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_more_than_65535_heads(cuda_device, dtype):
    """b * h = 66,560 (b 1024, h 65, s 8, d 8): K3, K4 and K5 against the
    twins (f32 at 2e-5 and 1e-4, bf16 through the emulation gates)."""
    causal = True
    rng = np.random.RandomState(3)
    q, k, v, dout = (torch.from_numpy(
        rng.randn(1024, 8, 65, 8).astype(np.float32)).to(cuda_device, dtype)
        for _ in range(4))
    out, lse = flash_forward(q, k, v, causal)
    p_out, p_lse = flash_forward_plain(q, k, v, causal)
    dk, dv = flash_backward_dkdv(q, k, v, p_out, p_lse, dout, causal)
    dq = flash_backward_dq(q, k, v, p_out, p_lse, dout, causal)
    if dtype == torch.bfloat16:
        assert_bf16_forward_passes_the_gate(out, lse, q, k, v, causal)
        assert_bf16_gradients_pass_the_gate((dq, dk, dv), q, k, v, p_out,
                                            p_lse, dout, causal)
        return
    torch.testing.assert_close(out, p_out, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(lse, p_lse, rtol=F32_TOL, atol=F32_TOL)
    p_dk, p_dv = flash_backward_dkdv_plain(q, k, v, p_out, p_lse, dout,
                                           causal)
    p_dq = flash_backward_dq_plain(q, k, v, p_out, p_lse, dout, causal)
    for got, want in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        torch.testing.assert_close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_bf16_backward_takes_unaligned_views(cuda_device):
    """Contiguous bf16 views at an odd element offset (not 16-byte
    aligned) give the aligned tensors' gradients bit for bit; float32
    refuses a precomputed delta and the pre-pass refuses float32."""
    causal, sq, d = True, 136, 40
    q, k, v, dout = flash_case(cuda_device, torch.bfloat16, causal, sq, sq, d)
    out, lse = flash_forward_plain(q, k, v, causal)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    want = (flash_backward_dq(q, k, v, out, lse, dout, causal),
            *flash_backward_dkdv(q, k, v, out, lse, dout, causal))
    views = [odd(t) for t in (q, k, v, out)] + [lse, odd(dout)]
    assert torch.equal(flash_backward_delta(views[3], views[5]),
                       flash_backward_delta(out, dout))
    got = (flash_backward_dq(*views, causal),
           *flash_backward_dkdv(*views, causal))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f32 = [t.float() for t in (q, k, v, out)] + [lse, dout.float()]
    with pytest.raises(ValueError, match="bfloat16"):
        flash_backward_delta(f32[3], f32[5])
    with pytest.raises(ValueError, match="delta= is for the bf16"):
        flash_backward_dq(*f32, causal, flash_backward_delta_plain(out, dout))


@pytest.mark.cuda
def test_bf16_flash_attention_runs_the_delta_pre_pass_once(cuda_device):
    """The autograd.Function's bf16 backward: one delta pre-pass, then K4
    and K5, each once; gradients within the gate."""
    q, k, v, dout = flash_case(cuda_device, torch.bfloat16, True, 256, 256,
                               64, seed=9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (flash_forward, flash_backward_delta, flash_backward_dkdv,
                flash_backward_dq)
    before = [fn.launches for fn in counters]
    flash_attention(*leaves, True).backward(dout)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1] * 4
    out, lse = flash_forward(q, k, v, True)
    assert_bf16_gradients_pass_the_gate([t.grad for t in leaves], q, k, v,
                                        out, lse, dout, True)


@pytest.mark.cuda
def test_flash_attention_function_runs_the_kernels(cuda_device):
    """The autograd.Function launches K3 forward and K4, K5 backward,
    and its gradients equal the CPU's at float32."""
    rng = np.random.RandomState(1)
    arrays = [rng.randn(2, 96, 2, 64).astype(np.float32) for _ in range(3)]
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in arrays)
        before = (flash_forward.launches, flash_backward_dkdv.launches,
                  flash_backward_dq.launches)
        (flash_attention(q, k, v, True) ** 2).sum().backward()
        after = (flash_forward.launches, flash_backward_dkdv.launches,
                 flash_backward_dq.launches)
        want = 1 if dev == cuda_device else 0
        assert tuple(a - b for a, b in zip(after, before)) == (want,) * 3
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_flash_wrapper_raises_on_cuda_tensors_it_cannot_take(cuda_device):
    q = torch.zeros((1, 16, 2, 12), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_forward(q, q, q, True)


def make_quant_case(seed, lengths, L, h=8, hd=128, page=128, n_pages=4,
                    pool=30):
    """K1q/K2q inputs: int8 pools with (pool, h) float32 scales from
    :func:`quantize_pages` of random data, a window of L query rows (row
    0 is K1q's query), shuffled tables."""
    q, kp, vp, table, lengths = make_chunk_case(seed, lengths, L, h=h, hd=hd,
                                                page=page, n_pages=n_pages,
                                                pool=pool)
    kd, ks = quantize_pages(torch.from_numpy(kp))
    vd, vs = quantize_pages(torch.from_numpy(vp))
    return q, kd, vd, ks, vs, table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, atol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_RTOL, BF16_ATOL),
])
def test_quant_kernels_match_their_twins_on_the_card(cuda_device, dtype,
                                                     rtol, atol):
    """K1q and K2q within tolerance of their plain twins, counted apart
    from K1 and K2; K2q's row j equal to K1q at lengths + j bit for bit,
    and a one-row window equal to K1q; 253's window crosses a split
    edge."""
    L = 5
    assert split_edge(128, 128, dtype, True) == 256
    q, kd, vd, ks, vs, table, lengths = make_quant_case(
        11, [0, 1, 124, 127, 128, 253, 300, 508], L)
    qt = torch.from_numpy(q).to(cuda_device, dtype)
    kd, vd, ks, vs = (t.to(cuda_device) for t in (kd, vd, ks, vs))
    tbl = torch.from_numpy(table).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    scales = dict(k_scale=ks, v_scale=vs)
    before = (paged_decode_attention.launches,
              paged_decode_attention.int8_launches,
              paged_chunk_attention.launches,
              paged_chunk_attention.int8_launches)
    one = paged_decode_attention(qt[:, 0].contiguous(), kd, vd, tbl, ln,
                                 **scales)
    out = paged_chunk_attention(qt, kd, vd, tbl, ln, **scales)
    assert (paged_decode_attention.launches,
            paged_decode_attention.int8_launches,
            paged_chunk_attention.launches,
            paged_chunk_attention.int8_launches) == (
        before[0], before[1] + 1, before[2], before[3] + 1)
    torch.testing.assert_close(
        one.float(), paged_decode_attention_plain(
            qt[:, 0].contiguous(), kd, vd, tbl, ln, ks, vs).float(),
        rtol=rtol, atol=atol)
    torch.testing.assert_close(
        out.float(), paged_chunk_attention_plain(qt, kd, vd, tbl, ln, ks,
                                                 vs).float(),
        rtol=rtol, atol=atol)
    assert (one[0] == 0).all() and (out[0, 0] == 0).all()
    for j in range(L):
        single = paged_decode_attention(qt[:, j].contiguous(), kd, vd, tbl,
                                        ln + j, **scales)
        assert torch.equal(out[:, j], single), f"window row {j} diverged"
    window = paged_chunk_attention(qt[:, :1].contiguous(), kd, vd, tbl, ln,
                                   **scales)
    assert torch.equal(window[:, 0], one)


@pytest.mark.cuda
def test_quant_wrapper_raises_on_cuda_tensors_it_cannot_take(cuda_device):
    q, kd, vd, ks, vs, table, lengths = make_quant_case(12, [3, 9], 1)
    args = [torch.from_numpy(q[:, 0]).to(cuda_device), kd.to(cuda_device),
            vd.to(cuda_device), torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device)]
    with pytest.raises(ValueError, match="scales must be"):
        paged_decode_attention(*args, k_scale=ks[:3].to(cuda_device),
                               v_scale=vs[:3].to(cuda_device))
    with pytest.raises(ValueError, match="must be int8"):
        paged_decode_attention(args[0], args[0].new_zeros(kd.shape),
                               args[0].new_zeros(vd.shape), *args[3:],
                               k_scale=ks.to(cuda_device),
                               v_scale=vs.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec-k3"])
def test_int8_batcher_on_the_card_matches_the_cpu_at_fp32(cuda_device, spec):
    """The int8 pool with quantized sealing, plain (K1q) and speculative
    (K2q, an int8 draft ring): card and CPU streams identical at fp32,
    pipelined and synchronous, with the launch counts of the path."""
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=97, num_layers=2, num_heads=2, hidden=256,
               max_seq=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 97, size=12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 97, size=n)])
               .astype(np.int32) for n in (3, 8, 1, 5, 11)]
    budgets = [20, 9, 15, 30, 12]
    kw = dict(cfg, slots=2, prompt_pad=24, page_size=8, pool_pages=24,
              token_budget=12, dtype=torch.float32, kv_dtype="int8",
              decode_page_cache="quantized")
    if spec:
        kw.update(draft_params=params, speculate_k=3, draft_num_layers=2,
                  draft_num_heads=2, draft_hidden=256)
    want = PagedContinuousBatcher(params, device="cpu", **kw).run(prompts,
                                                                  budgets)
    for pipeline in (True, False):
        card = PagedContinuousBatcher(params, device=cuda_device,
                                      pipeline_decode=pipeline, **kw)
        counts = (paged_decode_attention, paged_chunk_attention)
        before = [(fn.launches, fn.int8_launches) for fn in counts]
        assert card.run(prompts, budgets) == want
        (k1, k1q), (k2, k2q) = [(fn.launches - a, fn.int8_launches - b)
                                for fn, (a, b) in zip(counts, before)]
        steps = card.stats["spec_steps" if spec else "steps"]
        assert k1 == k2 == 0
        assert (k2q if spec else k1q) == steps * cfg["num_layers"]
        assert (k1q if spec else k2q) == 0
        assert card.stats["seal_requants"] > 0
        card.assert_page_accounting()


def _sse_submit(port, body):
    """POST one /v1/submit over loopback; returns its SSE events."""
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/submit", json.dumps(body),
                     {"Content-Type": "application/json"})
        raw = conn.getresponse().read().decode()
    finally:
        conn.close()
    events, ev = [], None
    for line in raw.splitlines():
        if line.startswith("event:"):
            ev = line[6:].strip()
        elif line.startswith("data:") and ev:
            events.append((ev, json.loads(line[5:].strip())))
    return events


@pytest.mark.cuda
def test_replica_server_on_the_card_serves_over_loopback(cuda_device):
    """A ReplicaServer over a card batcher, its requests posted
    concurrently over loopback: every stream's deltas concatenate to its
    ``done`` list, which equals the same batcher's in-process ``run``,
    and K1 launched decode steps x layers times on the serving thread."""
    import threading

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(vocab_size=97, num_layers=2, num_heads=2, hidden=256,
               max_seq=64)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 97, size=n).astype(np.int32)
               for n in (5, 17, 9, 23)]
    budgets = [12, 7, 20, 9]
    cb = PagedContinuousBatcher(params, device=cuda_device, slots=3,
                                prompt_pad=24, page_size=8, pool_pages=24,
                                dtype=torch.float32, **cfg)
    want = cb.run(prompts, budgets)
    cb._reset_stats()
    before = paged_decode_attention.launches
    srv = ReplicaServer(cb).start()
    got = {}

    def post(i):
        got[i] = _sse_submit(srv.port, {
            "request_id": f"r{i}", "prompt": prompts[i].tolist(),
            "max_new_tokens": budgets[i]})

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        srv.stop()
    launches = paged_decode_attention.launches - before
    for i, events in got.items():
        kind, done = events[-1]
        assert kind == "done", events[-1]
        deltas = sum((e["tokens"] for k, e in events[:-1]), [])
        assert deltas == done["tokens"] == want[i], i
    assert sorted(got) == list(range(len(prompts)))
    assert launches == cb.stats["steps"] * cfg["num_layers"] > 0
    cb.assert_page_accounting()
