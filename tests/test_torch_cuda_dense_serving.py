"""The dense batchers on the card (kubegpu_tpu_torch/models/serving.py::
ContinuousBatcher, models/spec_serving.py::SpeculativeContinuousBatcher),
on a card only (``-m cuda``; the tests skip without a CUDA device).

At float32 the card's streams must equal the CPU's for every prefill mode
(chunked, monolithic, under a token budget), for speculation and for
seed-pinned sampled traffic; a batcher built for the card keeps every
tensor there (no CPU fallback), and none of the port's kernels launches.
Random weights make near-ties rare at float32, so a differing token is a
fault here.  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_dense_serving.py -m cuda
"""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models.params import init_params
from kubegpu_tpu_torch.models.serving import ContinuousBatcher
from kubegpu_tpu_torch.models.spec_serving import SpeculativeContinuousBatcher
from kubegpu_tpu_torch.ops.attention import flash_forward
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
)

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, num_layers=2, num_heads=4, hidden=256,
           max_seq=96)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=64)
COUNTERS = ((paged_decode_attention, "launches"),
            (paged_decode_attention, "int8_launches"),
            (paged_chunk_attention, "launches"),
            (paged_chunk_attention, "int8_launches"),
            (flash_forward, "launches"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's batchers run only there")
    return torch.device("cuda")


@pytest.fixture
def weights():
    params = init_params(CFG, torch.Generator().manual_seed(2),
                         torch.float32, "cpu")
    draft = init_params(dict(vocab_size=512, num_layers=1, hidden=64,
                             max_seq=96), torch.Generator().manual_seed(5),
                        torch.float32, "cpu")
    return params, draft


def traffic():
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32)
               for n in (5, 19, 3, 28, 11, 1, 32, 14)]
    return prompts, [24, 17, 30, 9, 28, 20, 13, 25]


def launches():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def on_both(make, run):
    """(cpu streams, card streams, the card batcher)."""
    out = {}
    for d in ("cpu", "cuda"):
        cb = make(d)
        before = launches()
        out[d] = (run(cb), cb)
        assert launches() == before, "a dense path launched a kernel"
    return out["cpu"][0], out["cuda"][0], out["cuda"][1]


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=8), dict(prefill_chunk=None),
    dict(prefill_chunk=8, token_budget=12), dict(prefill_chunk="auto"),
], ids=["chunk8", "monolithic", "budget", "auto"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_continuous_batcher_card_equals_cpu(cuda_device, weights, kw,
                                            sampled):
    params, _ = weights
    prompts, budgets = traffic()
    run_kw = (dict(temperatures=[0.8, 0.0, 1.1, 0.7, 1.0, 0.9, 0.0, 1.2],
                   seeds=[100 + i for i in range(8)], ) if sampled else {})
    cpu, card, cb = on_both(
        lambda d: ContinuousBatcher(params, **CFG, slots=4, prompt_pad=32,
                                    dtype=torch.float32, device=d,
                                    top_k=50 if sampled else 0, **kw),
        lambda cb: cb.run(prompts, budgets, **run_kw))
    assert card == cpu
    assert cb.caches[0][0].is_cuda and cb.pos.is_cuda and cb._temps.is_cuda
    assert cb.stream is not None


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_speculative_batcher_card_equals_cpu(cuda_device, weights, k,
                                             sampled):
    params, draft = weights
    prompts, budgets = traffic()
    run_kw = (dict(temperatures=[0.8, 0.0, 1.1, 0.7, 1.0, 0.9, 0.0, 1.2],
                   seeds=[100 + i for i in range(8)]) if sampled else {})
    cpu, card, cb = on_both(
        lambda d: SpeculativeContinuousBatcher(
            params, draft, **CFG, **DRAFT, k=k, slots=4, prompt_pad=32,
            dtype=torch.float32, device=d, sampling=sampled),
        lambda cb: cb.run(prompts, budgets, **run_kw))
    assert card == cpu
    assert cb.d_caches[0][0].is_cuda and cb.pos.is_cuda
    if not sampled:
        dense = ContinuousBatcher(params, **CFG, slots=4, prompt_pad=32,
                                  dtype=torch.float32, device="cuda")
        assert dense.run(prompts, budgets) == card


def test_serve_step_reads_only_the_token_vector(cuda_device, weights,
                                                monkeypatch):
    """The steady loop uploads nothing: after the slots are admitted, a
    step moves no host array to the card (the active mask only moves
    when membership changes)."""
    params, _ = weights
    cb = ContinuousBatcher(params, **CFG, slots=2, prompt_pad=32,
                           dtype=torch.float32, device="cuda")
    for i in range(2):
        cb.submit(i, np.arange(5 + i, dtype=np.int32), 30)
    for _ in range(3):
        cb.serve_step()
    uploads = []
    real = torch.Tensor.to

    def spy(self, *a, **kw):
        if not self.is_cuda and any(
                getattr(x, "type", x) in ("cuda", torch.device("cuda"))
                for x in list(a) + list(kw.values())):
            uploads.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    for _ in range(5):
        cb.serve_step()
    assert uploads == []
