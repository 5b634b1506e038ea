"""The port's paged serving (kubegpu_tpu_torch/models/paging.py) against
the JAX package's at float32: the same flax weights and the same request
schedule give identical token streams from both
``PagedContinuousBatcher``s, in pipelined and synchronous mode, and the
port's page accounting holds at quiescence."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
    PagedDecodeLM as JaxPagedDecodeLM,
)
from kubegpu_tpu_torch.models.paging import (
    PagedContinuousBatcher,
    PagedDecodeLM,
    PrefixPageCache,
)
from kubegpu_tpu_torch.models.params import bind_params, params_from_numpy

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=32)
LOGIT_TOL = 1e-5
# 2 slots, 4-row pages, a 12-row prompt pad, a 9-page allocatable pool
# (requests 0 and 1 need 6 + 5 pages, so the second admission defers),
# a 6-row token budget (one prefill chunk per iteration)
BATCHER_KW = dict(slots=2, prompt_pad=12, page_size=4, pool_pages=10,
                  token_budget=6)
EOS_ID = 52          # ends requests 4 and 5 before their budgets
CANCEL_LIVE = 1      # cancelled mid-stream, after its second token
CANCEL_QUEUED = 3    # cancelled while still queued


@pytest.fixture(scope="module")
def jax_params():
    model = TransformerLM(dtype=jnp.float32, **CFG)
    return model.init(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))[
        "params"
    ]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def schedule():
    """Six requests for two slots: prompts longer than a page, three of
    them sharing a 9-token prefix (two full pages)."""
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 61, size=9).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.randint(0, 61, size=3)]),
        rng.randint(0, 61, size=10),
        np.concatenate([shared, rng.randint(0, 61, size=2)]),
        rng.randint(0, 61, size=3),
        np.concatenate([shared[:8], rng.randint(0, 61, size=1)]),
        rng.randint(0, 61, size=7),
    ]
    return [p.astype(np.int32) for p in prompts], [12, 9, 14, 6, 10, 8]


def drive(cb, prompts, budgets):
    """Submit everything, cancel one queued request at once and one live
    request after its second token, and serve to quiescence."""
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        cb.submit(i, p, m)
    assert cb.cancel(CANCEL_QUEUED)
    done, cut = {}, None
    while cb.has_work():
        done.update(cb.serve_step())
        live = cb.live_tokens()
        if cut is None and len(live.get(CANCEL_LIVE, [])) >= 2:
            cut = list(live[CANCEL_LIVE])
            assert cb.cancel(CANCEL_LIVE)
    return done, cut


def test_schedule_defers_an_admission():
    prompts, budgets = schedule()
    need = [-(-(len(p) + m) // BATCHER_KW["page_size"])
            for p, m in zip(prompts, budgets)]
    assert need[0] + need[1] > BATCHER_KW["pool_pages"] - 1


@pytest.mark.parametrize("pipeline", [True, False])
def test_batcher_streams_identical_to_jax(jax_params, torch_params,
                                          pipeline):
    prompts, budgets = schedule()
    jb = JaxPagedContinuousBatcher(
        jax_params, dtype=jnp.float32, eos_id=EOS_ID,
        pipeline_decode=pipeline, **CFG, **BATCHER_KW,
    )
    tb = PagedContinuousBatcher(
        torch_params, dtype=torch.float32, eos_id=EOS_ID,
        pipeline_decode=pipeline, device="cpu", **CFG, **BATCHER_KW,
    )
    want, want_cut = drive(jb, prompts, budgets)
    got, got_cut = drive(tb, prompts, budgets)
    assert got == want
    assert got_cut == want_cut and len(got_cut) >= 2
    assert sorted(got) == [0, 2, 4, 5]
    assert any(len(got[i]) < budgets[i] and got[i][-1] == EOS_ID
               for i in got)
    for key in ("steps", "admits", "prefill_chunks", "prefix_hit_tokens",
                "prefix_miss_tokens", "prompt_tokens", "peak_pages"):
        assert tb.stats[key] == jb.stats[key], key
    assert tb.stats["prefix_hit_tokens"] > 0
    tb.assert_page_accounting()
    assert not tb.has_work()


@pytest.mark.parametrize("knobs", [
    dict(station_slots=1),
    dict(prefill_chunk=8, token_budget=None),
    dict(prefix_cache=False, pipeline_decode=False),
], ids=["serial-station", "two-page-chunks", "no-prefix-cache"])
def test_batcher_knobs_keep_streams_identical_to_jax(jax_params, torch_params,
                                                     knobs):
    """The station, chunk and cache knobs change the schedule, never the
    tokens; a zero-budget request is a no-op admit on both sides."""
    prompts, budgets = schedule()
    prompts.append(prompts[0][:5])
    budgets.append(0)
    kw = {**BATCHER_KW, **knobs}
    jb = JaxPagedContinuousBatcher(jax_params, dtype=jnp.float32, **CFG, **kw)
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, **kw)
    want = jb.run(prompts, budgets)
    got = tb.run(prompts, budgets)
    assert got == want and got[len(prompts) - 1] == []
    for key in ("steps", "admits", "prefill_chunks", "prefix_hit_tokens"):
        assert tb.stats[key] == jb.stats[key], key
    tb.assert_page_accounting()


def test_three_passes_on_one_warm_batcher_are_identical(jax_params,
                                                        torch_params):
    """Later passes hit the prefix pages earlier passes registered; the
    streams must not move, and they equal the JAX batcher's."""
    prompts, budgets = schedule()
    want = JaxPagedContinuousBatcher(
        jax_params, dtype=jnp.float32, **CFG, **BATCHER_KW
    ).run(prompts, budgets)
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, **BATCHER_KW)
    hits = []
    for _ in range(3):
        assert tb.run(prompts, budgets) == want
        tb.assert_page_accounting()
        hits.append(tb.stats["prefix_hit_tokens"])
        assert set(tb.first_token_s) == set(range(len(prompts)))
    assert hits[1] > hits[0]


def test_paged_decode_lm_step_matches_jax(jax_params, torch_params):
    rng = np.random.RandomState(3)
    hd = CFG["hidden"] // CFG["num_heads"]
    pools = [
        tuple((rng.randn(6, CFG["num_heads"], 4, hd) * 0.3).astype(np.float32)
              for _ in range(2))
        for _ in range(CFG["num_layers"])
    ]
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 5, 0], np.int32)
    tokens = rng.randint(0, 61, size=(3, 1)).astype(np.int32)
    jl, jpools = JaxPagedDecodeLM(dtype=jnp.float32, **CFG).apply(
        {"params": jax_params}, jnp.asarray(tokens),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools],
        jnp.asarray(table), jnp.asarray(pos),
    )
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]
    model = bind_params(PagedDecodeLM(dtype=torch.float32, **CFG),
                        torch_params)
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), tpools, torch.from_numpy(table),
                   torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_pool_too_small_for_a_request_is_refused(torch_params):
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, slots=2, prompt_pad=8,
                                page_size=8, pool_pages=3)
    with pytest.raises(ValueError, match="pages"):
        tb.submit(0, np.arange(8, dtype=np.int32), 20)
    with pytest.raises(ValueError, match="prompt_pad"):
        tb.submit(0, np.arange(9, dtype=np.int32), 1)
    with pytest.raises(ValueError, match="multiple of"):
        PagedContinuousBatcher(torch_params, dtype=torch.float32,
                               device="cpu", **CFG, prompt_pad=6,
                               page_size=8)


@pytest.mark.parametrize("knob, slice_name", [
    # sampling, sampled speculation (tests/test_torch_spec_sampled.py) and
    # prefill-only serving (tests/test_torch_disaggregation.py) serve; a
    # later slice's knob refuses with them or without
    (dict(mesh=object()), "tensor-parallel"),
    (dict(mesh=object(), prefill_only=True), "tensor-parallel"),
    (dict(mesh=object(), sampling=True, top_k=5), "tensor-parallel"),
    (dict(mesh=object(), prefill_only=True, speculate_k=2, sampling=True),
     "tensor-parallel"),
    (dict(mesh=object(), prefill_only=True, top_k=5), "tensor-parallel"),
])
def test_knobs_of_later_slices_are_refused(torch_params, knob, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        PagedContinuousBatcher(torch_params, dtype=torch.float32,
                               device="cpu", **CFG, **BATCHER_KW, **knob)


@pytest.mark.parametrize("knob", [
    dict(prefill_only=True),
    dict(prefill_only=True, top_k=5),
    dict(prefill_only=True, speculate_k=2, sampling=True),
])
def test_prefill_only_serves(torch_params, knob):
    """``prefill_only`` no longer refuses: a request parks at its seal
    with zero tokens, is announced once, and unparks locally."""
    if "speculate_k" in knob:
        knob = dict(knob, draft_params=torch_params,
                    draft_num_layers=CFG["num_layers"],
                    draft_num_heads=CFG["num_heads"],
                    draft_hidden=CFG["hidden"])
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, **BATCHER_KW, **knob)
    tb.submit(0, np.arange(1, 6, dtype=np.int32), 4)
    sealed = []
    for _ in range(20):
        tb.serve_step()
        sealed += tb.drain_sealed()
    assert sealed == [0] and tb.live_tokens() == {0: []}
    assert tb.set_prefill_only(False)
    out = {}
    while tb.has_work():
        out.update(tb.serve_step())
    assert len(out[0]) == 4
    tb.assert_page_accounting()


@pytest.mark.parametrize("knob", ["metrics", "tracer", "ledger_size"])
def test_knobs_of_the_http_slice_serve(torch_params, knob):
    """Metrics, request tracing and the step ledger serve now
    (tests/test_torch_replica_batcher.py holds them against the JAX
    package)."""
    from kubegpu_tpu_torch.utils.metrics import Metrics
    from kubegpu_tpu_torch.utils.tracing import Tracer

    value = {"metrics": Metrics(), "tracer": Tracer(),
             "ledger_size": 3}[knob]
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, **BATCHER_KW,
                                **{knob: value})
    prompts, budgets = schedule()
    out = tb.run(prompts[:2], budgets[:2])
    assert [len(out[i]) for i in (0, 1)] == budgets[:2]
    assert 0 < len(tb.ledger_rows()) <= (3 if knob == "ledger_size" else 512)
    tb.assert_page_accounting()


@pytest.mark.parametrize("knob", [
    dict(quant=True), dict(kv_dtype="int8"), dict(decode_page_cache="fp32"),
], ids=["int8-weights", "int8-pool", "decode-page-sealing"])
def test_knobs_of_the_int8_slice_serve(torch_params, knob):
    """Weight-only int8, the int8 pool and retirement sealing serve now
    (tests/test_torch_quantized_pool.py holds them against the JAX
    package)."""
    params = torch_params
    if knob.get("quant"):
        from kubegpu_tpu_torch.models.decoding import quantize_params_int8
        params = quantize_params_int8(torch_params)
    tb = PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                **CFG, **BATCHER_KW, **knob)
    prompts, budgets = schedule()
    out = tb.run(prompts[:2], budgets[:2])
    assert [len(out[i]) for i in (0, 1)] == budgets[:2]
    tb.assert_page_accounting()


def test_malformed_knobs_raise_value_errors(torch_params):
    for knob in (dict(kv_dtype="fp16"), dict(kv_dtype="bf16"),
                 dict(decode_page_cache="sometimes"),
                 dict(token_budget=0), dict(station_slots=0)):
        with pytest.raises(ValueError):
            PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                   device="cpu", **CFG,
                                   **{**BATCHER_KW, **knob})


def test_sampled_requests_are_refused_at_submit(torch_params):
    """Only a greedy-only speculative batcher refuses a sampled request,
    as the JAX batcher does: a plain batcher samples (the streams are
    held against JAX in tests/test_torch_spec_sampled.py), and a seed at
    temperature 0 is a greedy request everywhere."""
    prompt = np.arange(3, dtype=np.int32)
    tb = PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                device="cpu", **CFG, **BATCHER_KW)
    tb.submit(0, prompt, 2, temperature=0.8)
    tb.submit(1, prompt, 2, seed=1)
    done = {}
    while tb.has_work():
        done.update(tb.serve_step())
    assert [len(done[i]) for i in (0, 1)] == [2, 2]
    spec = PagedContinuousBatcher(
        torch_params, dtype=torch.float32, device="cpu", **CFG,
        **BATCHER_KW, draft_params=torch_params, speculate_k=2,
        draft_num_layers=CFG["num_layers"], draft_num_heads=CFG["num_heads"],
        draft_hidden=CFG["hidden"])
    with pytest.raises(ValueError, match="greedy-only"):
        spec.submit(0, prompt, 2, temperature=0.8)
    spec.submit(1, prompt, 2, seed=1)


def test_prefix_page_cache_refcounts_and_lru():
    cache = PrefixPageCache()
    cache.insert(b"a", 3)
    cache.insert(b"b", 4)
    assert cache.lookup(b"b") == 4 and cache.refcount(4) == 1
    assert cache.acquire(b"a") == 3 and cache.refcount(3) == 2
    assert cache.acquire(b"c") is None
    cache.release(3)
    cache.release(3)
    cache.release(4)
    assert cache.idle_count() == 2 and cache.pages() == {3, 4}
    # LRU: "a" was acquired last, so "b" goes first
    assert cache.evict_lru() == 4
    assert cache.evict_lru() == 3 and cache.evict_lru() is None
    cache.assert_consistent()
    assert len(cache) == 0
