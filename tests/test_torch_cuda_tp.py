"""Tensor-parallel paged serving on a card only (``-m cuda``; the tests
skip without a CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_tp.py -m cuda

- The head-sharded wrappers (``paged_decode_attention_sharded``,
  ``paged_chunk_attention_sharded``) on each rank's half of the heads:
  K1, K1q, K2 and K2q within the twins' tolerances of their plain
  versions on the same half, and equal, bit for bit, to the unsharded
  kernel's result for those heads (every head's walk is independent).
- A two-rank gloo gang with both ranks on ``cuda:0`` (NCCL refuses two
  ranks on one card) at a small width and float32: plain, speculative
  and int8-pool streams equal the unsharded card batcher's, each rank
  rests half its pool, and each rank launched its kernel steps x layers
  times."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import init_params
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_chunk_attention_sharded,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_sharded,
    quantize_pages,
)
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
import torch_tp_cases as cases

F32_TOL = 2e-5
TP = 2
CFG = dict(vocab_size=512, num_layers=2, num_heads=4, hidden=256,
           max_seq=160)
KW = dict(slots=4, prompt_pad=64, page_size=16, pool_pages=48)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


def rank_mesh(rank):
    """A rank's view for the wrappers, which run no collective."""
    return Mesh(size=TP, rank=rank, device=torch.device("cuda"),
                backend="gloo")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("L", [1, 5], ids=["K1", "K2"])
def test_sharded_wrappers_match_twins_and_the_unsharded_kernel(
        cuda_device, L, quant):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, hd, page, n_pages, pool = 4, 8, 128, 16, 6, 40
    table = torch.stack([torch.randperm(pool, generator=g,
                                        device=cuda_device)[:n_pages]
                         for _ in range(b)]).to(torch.int32)
    lengths = torch.tensor([0, 7, 33, n_pages * page - L], dtype=torch.int32,
                           device=cuda_device)
    shape = (b, h, hd) if L == 1 else (b, L, h, hd)
    q = torch.randn(shape, generator=g, device=cuda_device)
    kp, vp = (torch.randn((pool, h, page, hd), generator=g,
                          device=cuda_device) * 0.3 for _ in range(2))
    sc = {}
    if quant:
        (kp, ks), (vp, vs) = quantize_pages(kp), quantize_pages(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    kernel, plain, sharded = (
        (paged_decode_attention, paged_decode_attention_plain,
         paged_decode_attention_sharded) if L == 1 else
        (paged_chunk_attention, paged_chunk_attention_plain,
         paged_chunk_attention_sharded))
    whole = kernel(q, kp, vp, table, lengths, **sc)
    w = h // TP
    for rank in range(TP):
        heads = slice(rank * w, (rank + 1) * w)
        qs = q[..., heads, :].contiguous()
        ks_ = kp[:, heads].contiguous()
        vs_ = vp[:, heads].contiguous()
        scs = {k: v[:, heads].contiguous() for k, v in sc.items()}
        out = sharded(qs, ks_, vs_, table, lengths, rank_mesh(rank), h,
                      **scs)
        want = plain(qs, ks_, vs_, table, lengths, **scs)
        torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)
        assert torch.equal(out, whole[..., heads, :])
    with pytest.raises(ValueError, match="heads"):
        sharded(q, kp, vp, table, lengths, rank_mesh(0), h, **sc)


@pytest.mark.cuda
def test_gloo_gang_on_one_card_serves_the_unsharded_streams(cuda_device,
                                                             tmp_path):
    params = init_params(CFG, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    np_params = _to_numpy(params)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (5, 40, 17, 64, 33, 9)]
    budgets = [20, 12, 30, 8, 16, 24]
    modes = {"plain": {}, "speculative": dict(
        speculate_k=2, draft_num_layers=1, draft_num_heads=2,
        draft_hidden=128), "int8-pool": dict(kv_dtype="int8")}
    with Gang(TP, str(tmp_path), backend="gloo", devices=["cuda:0"] * TP,
              timeout_s=600.0) as gang:
        for name, kw in modes.items():
            spec = "speculate_k" in kw
            draft = None
            if spec:
                draft = _to_numpy(init_params(
                    dict(CFG, num_layers=1, hidden=128),
                    torch.Generator().manual_seed(7), torch.float32, "cpu"))
            ref_cb = PagedContinuousBatcher(
                params, dtype=torch.float32, device="cuda", **CFG,
                **dict(KW, **kw),
                **(dict(draft_params=cases.weights(draft, "cuda"))
                   if spec else {}))
            ref = ref_cb.run(prompts, budgets)
            got = gang.run(cases.serve, dict(params=np_params, cfg=CFG,
                                             kw=dict(KW, **kw),
                                             draft=draft),
                           prompts, budgets)
            assert got["streams"] == ref, name
            full = cases.rank_bytes(ref_cb)
            steps = got["stats"]["steps"]
            key = ("K2" if spec else "K1") + ("q" if "kv_dtype" in kw
                                              else "")
            for sizes, launches in zip(got["rank_bytes"],
                                       got["rank_launches"]):
                assert {k: 2 * v for k, v in sizes.items()} == full, name
                assert launches[key] == steps * CFG["num_layers"], (
                    name, launches, steps)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}
