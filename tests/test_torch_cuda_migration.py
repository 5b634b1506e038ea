"""Live KV migration card to card (kubegpu_tpu_torch/models/paging.py and
the wire codec of gateway/dataplane.py), on a card only (``-m cuda``;
the tests skip without a CUDA device).

A sequence exported mid-decode from one card batcher crosses the codec
(JSON and back) into a second card batcher and must finish equal to the
un-migrated stream on the same card, with the importer's pool holding
the exported bytes and the paged kernels (K1, K1q, K2, K2q) launched for
the imported sequence's steps.  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_migration.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.gateway.dataplane import (
    decode_kv_payload,
    encode_kv_payload,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import init_params, tree_map
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
)

CFG = dict(vocab_size=512, num_layers=2, num_heads=4, hidden=256,
           max_seq=160)
KW = dict(slots=4, prompt_pad=64, page_size=16, pool_pages=48)
PROMPT = np.arange(3, 43, dtype=np.int32) % 500


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


def build(params, dtype, spec, **kw):
    extra = (dict(speculate_k=4, draft_params=params,
                  draft_num_layers=CFG["num_layers"],
                  draft_num_heads=CFG["num_heads"],
                  draft_hidden=CFG["hidden"]) if spec else {})
    return PagedContinuousBatcher(params, dtype=dtype, device="cuda", **CFG,
                                  **dict(KW, **kw), **extra)


def drain(cb):
    out = {}
    while cb.has_work():
        out.update(cb.serve_step())
    return out


def counters(quant, spec):
    fn = paged_chunk_attention if spec else paged_decode_attention
    return fn, "int8_launches" if quant else "launches"


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_card_to_card_live_migration(cuda_device, pool, spec):
    quant = pool == "int8"
    dtype = torch.bfloat16 if pool == "bfloat16" else torch.float32
    kw = dict(kv_dtype="int8") if quant else {}
    params = init_params(CFG, torch.Generator(cuda_device).manual_seed(0),
                         dtype, cuda_device)
    budget = 40
    ref = build(params, dtype, spec, **kw).run([PROMPT], [budget])[0]
    src = build(params, dtype, spec, **kw)
    src.submit(1, PROMPT, budget)
    for _ in range(200):
        src.serve_step()
        if len(src.live_tokens().get(1, [])) >= 6:
            break
    payload = src.export_pages(1)
    src.cancel(1)
    src.assert_page_accounting()
    wire = json.loads(json.dumps(encode_kv_payload(payload)))
    got = decode_kv_payload(wire)
    dst = build(params, dtype, spec, **kw)
    fn, attr = counters(quant, spec)
    before = getattr(fn, attr)
    dst.import_pages(7, got)
    s = next(s for s in dst._seqs if s.seq_id == 7)
    n = len(payload["page_keys"])
    idx = torch.tensor(s.pages[:n], device=cuda_device)
    for li, (k_np, _) in enumerate(payload["layers"]):
        held = dst.pools[li][0]
        held = (held[0] if quant else held)[idx]
        if dtype == torch.bfloat16:
            held = held.view(torch.int16)
        assert held.cpu().numpy().tobytes() == np.ascontiguousarray(
            k_np).tobytes()
    out = drain(dst)
    assert out[7] == ref
    steps = dst.stats["steps"]
    assert getattr(fn, attr) - before == steps * CFG["num_layers"] > 0
    dst.assert_page_accounting()


@pytest.mark.cuda
def test_card_to_cpu_and_back(cuda_device):
    """A float32 sequence moves card to CPU and CPU to card mid-decode
    and finishes as the card's un-migrated stream would."""
    params = init_params(CFG, torch.Generator(cuda_device).manual_seed(1),
                         torch.float32, cuda_device)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    ref = build(params, torch.float32, False).run([PROMPT], [30])[0]
    card = build(params, torch.float32, False)
    card.submit(1, PROMPT, 30)
    for _ in range(100):
        card.serve_step()
        if len(card.live_tokens().get(1, [])) >= 4:
            break
    cpu = PagedContinuousBatcher(cpu_params, dtype=torch.float32,
                                 device="cpu", **CFG, **KW)
    cpu.import_pages(2, card.export_pages(1))
    card.cancel(1)
    for _ in range(6):
        cpu.serve_step()
    back = build(params, torch.float32, False)
    back.import_pages(3, cpu.export_pages(2))
    cpu.cancel(2)
    assert drain(back)[3] == ref
