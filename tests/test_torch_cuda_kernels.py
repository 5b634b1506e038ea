"""The port's hand-written CUDA kernels (K1, K2) against their plain
PyTorch twins, on a card only (``-m cuda``; they skip without a CUDA device).

This file imports no JAX, so it also runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Its input helpers are shared with the CPU parity tests of
tests/test_torch_paged_attention.py."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)

# the reference's own kernel tolerance (tests/test_paging.py)
F32_TOL = 2e-5
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
    case = make_case(6, [3, 9], b=2, h=4, hd=8, page=4, n_pages=3, pool=8)
    with pytest.raises(ValueError, match="head_dim"):
        run_torch(paged_decode_attention, case, torch.float32, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [True, False])
def test_batcher_on_the_card_matches_the_cpu_at_fp32(cuda_device, pipeline):
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
    one-row window equal to K1."""
    L = 5
    q, kp, vp, table, lengths = make_chunk_case(
        7, [0, 1, 124, 127, 128, 300, 508], L, h=8, hd=128, page=128,
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
