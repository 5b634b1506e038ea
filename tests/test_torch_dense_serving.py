"""The port's dense continuous batcher (kubegpu_tpu_torch/models/
serving.py::ContinuousBatcher) against the JAX package's at float32 on
the CPU: the same flax weights (``params_from_numpy``) and the same numpy
requests give identical token streams and ``stats``.

Covered: chunk sizes 1, 3, ``prompt_pad``, ``"auto"`` and ``None`` (the
monolithic admit), a token budget that tapers prefill, EOS, zero budgets,
cancels mid-prefill and mid-decode with ``live_tokens`` after every
``serve_step``, int8 weights, mixed greedy and sampled requests (top-k,
seed-pinned and unpinned), the live cache rows after a run (within
1e-5), the constructor's and ``submit``'s refusals (same types and
messages), and the trace trees and metric counts.  Mirrors
tests/test_generate.py's and tests/test_serving_chunked.py's dense
batcher cases and tests/test_sampled_spec.py's seed-pinned grid."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    quantize_params_int8 as jax_quantize_params_int8,
)
from kubegpu_tpu.models.serving import (
    ContinuousBatcher as JaxContinuousBatcher,
    record_quant_quality as jax_record_quant_quality,
    record_sampling_quality as jax_record_sampling_quality,
)
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu.utils.tracing import Tracer as JaxTracer, validate_trace
from kubegpu_tpu_torch.models.decoding import (
    greedy_generate,
    quantize_params_int8,
)
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.models.serving import (
    ContinuousBatcher,
    record_quant_quality,
    record_sampling_quality,
    resolve_prefill_chunk,
)
from kubegpu_tpu_torch.utils.metrics import Metrics
from kubegpu_tpu_torch.utils.tracing import Tracer

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=32)
# live cache rows of two float32 implementations that differ only in
# summation order
CACHE_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def pair(weights, quant=False, **kw):
    """The JAX batcher and the port's, built alike at float32."""
    jp, tp = weights
    if quant:
        jp = jax_quantize_params_int8(jp)
        tp = quantize_params_int8(tp)
    kw = dict(CFG, **kw)
    return (JaxContinuousBatcher(jp, dtype=jnp.float32, quant=quant, **kw),
            ContinuousBatcher(tp, dtype=torch.float32, quant=quant,
                              device="cpu", **kw))


def traffic(seed=0, lengths=(1, 2, 3, 4, 5, 7, 8, 9, 16)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=n).astype(np.int32)
            for n in lengths]


BUDGETS = [5, 4, 6, 3, 5, 4, 6, 5, 7]


def live_rows_close(jb, tb):
    """Every slot's rows below its position: the K/V its last sequence
    wrote, in both batchers."""
    pos = np.asarray(jb.pos)
    np.testing.assert_array_equal(tb.pos.numpy(), pos)
    for (jk, jv), (tk, tv) in zip(jb.caches, tb.caches):
        for j, t in ((jk, tk), (jv, tv)):
            for slot, p in enumerate(pos):
                np.testing.assert_allclose(
                    t[slot, :p].numpy(), np.asarray(j)[slot, :p],
                    rtol=CACHE_TOL, atol=CACHE_TOL)


# "auto" resolves to the whole prompt_pad (16) here
@pytest.mark.parametrize("chunk, budget", [
    (1, None), (3, None), ("auto", None), (None, None), (3, 5),
], ids=["chunk1", "chunk3", "auto-pad", "monolithic", "chunk3-budget5"])
def test_greedy_streams_and_stats_equal_jax(weights, chunk, budget):
    jb, tb = pair(weights, slots=3, prompt_pad=16, prefill_chunk=chunk,
                  token_budget=budget)
    prompts = traffic()
    want = jb.run(prompts, BUDGETS)
    got = tb.run(prompts, BUDGETS)
    assert got == want
    assert tb.stats == jb.stats
    assert tb.prefill_chunk == jb.prefill_chunk == (
        16 if chunk == "auto" else chunk)
    if chunk is not None:
        # sum over prompts of ceil((plen - 1) / chunk)
        c = tb.prefill_chunk
        assert tb.stats["prefill_chunks"] == sum(
            -(-(len(p) - 1) // c) for p in prompts)
    live_rows_close(jb, tb)


def oracle(tp, prompt, n):
    """One sequence alone through the port's aligned greedy decode (held
    against JAX's in tests/test_torch_decoding.py)."""
    out = greedy_generate(tp, torch.from_numpy(prompt)[None], n,
                          dtype=torch.float32, device="cpu", **CFG)
    return out[0, len(prompt):].tolist()


def test_streams_equal_per_sequence_greedy(weights):
    """tests/test_generate.py:157: five sequences through two slots equal
    each sequence's aligned greedy decode."""
    _, tp = weights
    prompts = traffic(0, (3, 5, 7, 4, 6))
    budgets = [6, 3, 5, 7, 4]
    expected = {i: oracle(tp, p, n)
                for i, (p, n) in enumerate(zip(prompts, budgets))}
    for chunk in ("auto", None):
        _, tb = pair(weights, slots=2, prompt_pad=8, prefill_chunk=chunk)
        assert tb.run(prompts, budgets) == expected
        assert tb.stats["admits"] == 5
        assert tb.stats["steps"] <= sum(budgets)


@pytest.mark.parametrize("chunk", [4, None])
def test_eos_frees_the_slot_early(weights, chunk):
    """tests/test_generate.py:198: a request whose first token is EOS
    retires at once, and its slot serves the next queued prompt."""
    prompts = traffic(1, (4, 4, 4))
    eos = oracle(weights[1], prompts[1], 1)[0]
    jb, tb = pair(weights, slots=1, prompt_pad=8, eos_id=eos,
                  prefill_chunk=chunk)
    want = jb.run(prompts, [8, 8, 8])
    assert tb.run(prompts, [8, 8, 8]) == want
    assert want[1] == [eos] and tb.stats == jb.stats


def test_zero_budget_and_oversized_prompt(weights):
    """tests/test_generate.py:277 and :410: a zero budget is an empty
    result; an oversized prompt is refused whatever its budget."""
    for chunk in (4, None):
        jb, tb = pair(weights, slots=1, prompt_pad=8, prefill_chunk=chunk)
        prompts = [np.array([1, 2, 3], np.int32), np.array([4, 5], np.int32)]
        want = jb.run(prompts, [0, 3])
        assert tb.run(prompts, [0, 3]) == want
        assert want[0] == [] and len(want[1]) == 3
        assert tb.run([np.arange(6, dtype=np.int32)], [0]) == {0: []}
        for b in (jb, tb):
            with pytest.raises(ValueError, match="prompt_pad"):
                b.run([np.arange(9, dtype=np.int32)], [0])


def errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the refusal is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", [
    dict(prompt_pad=64),
    dict(prompt_pad=8, prefill_chunk=0),
    dict(prompt_pad=16, max_seq=20, prefill_chunk=12),
    dict(prompt_pad=8, token_budget=0),
    dict(prompt_pad=8, prefill_chunk=None, token_budget=8),
    dict(prompt_pad=8, top_k=62),
], ids=["pad-past-cache", "chunk0", "chunk-spills", "budget0",
        "budget-monolithic", "top-k"])
def test_constructor_refusals_equal_jax(weights, kw):
    jp, tp = weights
    cfg = dict(CFG, slots=1)
    cfg.update(kw)
    want = errors(lambda: JaxContinuousBatcher(jp, dtype=jnp.float32, **cfg))
    got = errors(lambda: ContinuousBatcher(tp, dtype=torch.float32,
                                           device="cpu", **cfg))
    assert want is not None and got == want


def test_prefill_chunk_auto_rule():
    # 128 when the last padded chunk fits, the whole pad when shorter,
    # monolithic when a chunk of 128 would spill
    assert resolve_prefill_chunk("auto", 128, 512) == 128
    assert resolve_prefill_chunk("auto", 16, 32) == 16
    assert resolve_prefill_chunk("auto", 200, 210) is None
    assert resolve_prefill_chunk(40, 16, 32) == 16


@pytest.mark.parametrize("args", [
    (-1, [1, 2], 2), (0, [], 2), (0, list(range(9)), 2),
    (0, list(range(8)), 25),
], ids=["seq-id", "empty", "past-pad", "past-cache"])
def test_submit_refusals_equal_jax(weights, args):
    jb, tb = pair(weights, slots=1, prompt_pad=8)
    seq, prompt, budget = args
    prompt = np.asarray(prompt, np.int32)
    want = errors(lambda: jb.submit(seq, prompt, budget))
    assert want is not None
    assert errors(lambda: tb.submit(seq, prompt, budget)) == want


def drive_with_cancels(cb):
    """Requests 0-3 at once through two slots with a chunk of 3: request
    1 is cancelled mid-prefill, request 0 after its second token,
    request 3 while queued; ``live_tokens`` after every step."""
    prompts = traffic(4, (9, 13, 5, 7, 6))
    budgets = [9, 6, 7, 5, 4]
    for i in range(4):
        cb.submit(i, prompts[i], budgets[i])
    assert cb.cancel(3)
    seen, done, it = [], {}, 0
    while cb.has_work():
        done.update(cb.serve_step())
        live = cb.live_tokens()
        seen.append(live)
        if it == 0:
            assert cb._slots[1].prompt is not None  # still prefilling
            assert cb.cancel(1)
        if len(live.get(0, [])) == 2:
            assert cb.cancel(0)
            cb.submit(4, prompts[4], budgets[4])
        it += 1
    assert not cb.cancel(0) and not cb.cancel(99)
    return done, seen


def test_cancels_and_live_tokens_equal_jax(weights):
    jb, tb = pair(weights, slots=2, prompt_pad=16, prefill_chunk=3)
    want = drive_with_cancels(jb)
    got = drive_with_cancels(tb)
    assert got == want
    assert sorted(want[0]) == [2, 4]
    assert tb.stats == jb.stats


@pytest.mark.parametrize("chunk", [3, None])
def test_int8_weights_equal_jax(weights, chunk):
    jb, tb = pair(weights, quant=True, slots=3, prompt_pad=16,
                  prefill_chunk=chunk)
    prompts = traffic(2)
    want = jb.run(prompts, BUDGETS)
    assert tb.run(prompts, BUDGETS) == want
    assert tb.stats == jb.stats
    live_rows_close(jb, tb)


def test_mixed_sampling_equals_jax(weights):
    """tests/test_generate.py:365: greedy neighbours of a sampled request
    keep their greedy stream; the unpinned sampled stream follows the
    batcher seed, as JAX's does (chunked and monolithic admits); top_k=1
    is greedy."""
    prompts = traffic(3, (3, 5, 4))
    budgets = [5, 5, 5]
    temps = [0.0, 5.0, 0.0]
    runs = {}
    for name, kw, t, jax_too in (
            ("base", {}, None, False),
            ("seed7", dict(seed=7), temps, True),
            ("seed8", dict(seed=8, prefill_chunk=None), temps, True),
            ("top1", dict(top_k=1), [2.0] * 3, False)):
        kw = dict(dict(prefill_chunk=4), **kw)
        jb, tb = pair(weights, slots=2, prompt_pad=8, **kw)
        runs[name] = tb.run(prompts, budgets, temperatures=t)
        if jax_too:
            assert runs[name] == jb.run(prompts, budgets, temperatures=t)
    assert runs["seed7"][0] == runs["base"][0]
    assert runs["seed7"][1] != runs["seed8"][1]
    assert runs["top1"] == runs["base"]


TEMPS = [0.9, 0.0, 1.2, 0.8]
SEEDS = [41, None, 42, 43]


def test_seed_pinned_grid_equals_jax(weights):
    """tests/test_sampled_spec.py:195 in both packages: a pinned stream
    is the same across slot counts, chunking, batch composition and a
    fresh batcher, and equal to JAX's; top-k truncation too."""
    prompts = traffic(9, (3, 5, 7, 4))
    budgets = [8, 6, 7, 5]
    ref = None
    for kw, jax_too in ((dict(slots=4), True),
                        (dict(slots=2, prefill_chunk=None), True),
                        (dict(slots=3, prefill_chunk=2), False)):
        jb, tb = pair(weights, prompt_pad=8, **kw)
        got = tb.run(prompts, budgets, temperatures=TEMPS, seeds=SEEDS)
        if jax_too:
            assert got == jb.run(prompts, budgets, temperatures=TEMPS,
                                 seeds=SEEDS), kw
        ref = got if ref is None else ref
        assert got == ref
    _, tb = pair(weights, slots=4, prompt_pad=8)
    assert tb.run([prompts[2]], [budgets[2]], temperatures=[TEMPS[2]],
                  seeds=[42])[0] == ref[2]
    jb, tb = pair(weights, slots=2, prompt_pad=8, top_k=5, seed=3)
    want = jb.run(prompts, budgets, temperatures=TEMPS, seeds=SEEDS)
    assert tb.run(prompts, budgets, temperatures=TEMPS, seeds=SEEDS) == want


def test_chunking_bounds_the_work_per_step(weights):
    """tests/test_serving_chunked.py:83: a long prompt admitted beside a
    decoding request adds one chunk a step, so the runner emits every
    step; its tokens as they land equal JAX's."""
    runs = []
    for cb in pair(weights, slots=2, prompt_pad=16, prefill_chunk=4):
        prompts = traffic(3, (2, 16))
        cb.submit(0, prompts[0], 12)
        cb.serve_step()
        cb.submit(1, prompts[1], 4, session_id="s1")
        emitted, done = [len(cb._slots[0].tokens)], {}
        while cb.has_work():
            done.update(cb.serve_step())
            emitted.append(len(cb._slots[0].tokens))
        deltas = [b - a for a, b in zip(emitted, emitted[1:]) if a < 12]
        assert all(d == 1 for d in deltas), deltas
        runs.append((emitted, done))
    assert runs[1] == runs[0]


def test_a_chunk_leaves_other_slots_rows_bit_identical(weights):
    """A chunk writes only the rows of the slots it advances: a decoding
    neighbour's rows, and every row of an idle slot, keep their bits
    (the in-place attention runs on the gathered sub-batch)."""
    _, tb = pair(weights, slots=3, prompt_pad=16, prefill_chunk=4)
    tb.submit(0, traffic(5, (3,))[0], 20)
    for _ in range(3):
        tb.serve_step()
    before = [(k.clone(), v.clone()) for k, v in tb.caches]
    chunks = tb.stats["prefill_chunks"]
    tb.submit(1, traffic(6, (16,))[0], 2)
    tb._sweep({})
    tb._advance_prefill()
    assert tb.stats["prefill_chunks"] == chunks + 1
    assert tb._slots[1].seq_id == 1 and tb._slots[1].prefill_pos == 4
    for (k0, v0), (k1, v1) in zip(before, tb.caches):
        for old, new in ((k0, k1), (v0, v1)):
            assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
            assert torch.equal(new[1, 4:], old[1, 4:])
            assert not torch.equal(new[1, :4], old[1, :4])


def shape(spans):
    """A trace as nested (name, retire reason, children) in span order."""
    kids = {}
    for s in sorted(spans, key=lambda s: s["span"]):
        kids.setdefault(s["parent"], []).append(s)

    def node(s):
        return (s["name"], s["attrs"].get("reason"),
                tuple(node(c) for c in kids.get(s["span"], [])))

    root, = kids[None]
    return node(root)


@pytest.mark.parametrize("chunk", [4, None])
def test_traces_and_metrics_equal_jax(weights, chunk):
    """tests/test_serving_chunked.py:276 in both packages, with a tracer:
    equal histogram counts and chunk counters, and for every request the
    same span tree with one retire of the same reason."""
    sides = []
    for metrics, tracer, cls in ((JaxMetrics(), JaxTracer(), 0),
                                 (Metrics(), Tracer(), 1)):
        cb = pair(weights, slots=2, prompt_pad=16, prefill_chunk=chunk,
                  metrics=metrics, tracer=tracer)[cls]
        prompts = traffic(6, (9, 9, 5, 12))
        out = cb.run(prompts, [4, 4, 0, 6])
        sides.append((out, metrics, tracer, cb))
    (jo, jm, jtr, jb), (to, tm, ttr, tb) = sides
    assert to == jo and tb.stats == jb.stats
    for name in ("serve_ttft_seconds", "serve_itl_seconds"):
        assert tm.histogram_count(name) == jm.histogram_count(name) > 0
    assert tm.get("serve_prefill_chunks_total") == jm.get(
        "serve_prefill_chunks_total")
    for phase in ("queue", "prefill", "first_step", "decode"):
        assert (tm.histogram_count("serve_phase_seconds", phase=phase)
                == jm.histogram_count("serve_phase_seconds", phase=phase)
                ), phase
    jt = {s[0]["attrs"]["seq_id"]: s for s in jtr.completed()}
    tt = {s[0]["attrs"]["seq_id"]: s for s in ttr.completed()}
    assert sorted(tt) == sorted(jt) == [0, 1, 2, 3]
    for seq in jt:
        assert shape(tt[seq]) == shape(jt[seq]), seq
        assert not validate_trace(tt[seq])
    assert ttr.open_count() == 0
    for seq, ttft in tb.first_token_s.items():
        decode = next(s for s in tt[seq] if s["name"] == "decode")
        assert decode["attrs"]["measured_ttft"] == pytest.approx(ttft)


def test_trace_shutdown_closes_live_requests(weights):
    tracer = Tracer()
    _, tb = pair(weights, slots=1, prompt_pad=8, prefill_chunk=2,
                 tracer=tracer)
    for i, n in enumerate((7, 3)):
        tb.submit(i, np.arange(n, dtype=np.int32), 5)
    tb.serve_step()
    tb.trace_shutdown("replica server stopped")
    assert tracer.open_count() == 0
    reasons = sorted(next(s["attrs"]["reason"] for s in spans
                          if s["name"] == "retire")
                     for spans in tracer.completed())
    assert reasons == ["died", "died"]


def test_quality_gauges_equal_jax():
    jm, tm = JaxMetrics(), Metrics()
    for rq, rs, m in ((jax_record_quant_quality, jax_record_sampling_quality,
                       jm),
                      (record_quant_quality, record_sampling_quality, tm)):
        rq(m, agreement=0.97, margin=3e-4, ppl_delta=0.01)
        rs(m, accept_rate=0.4, nll_delta=-0.002, unigram_agreement=0.9,
           lane="paged")
        rq(None, agreement=1.0)
        rs(None, accept_rate=1.0)
    assert tm.render() == jm.render()
    assert tm.gauge("serve_sampled_accept_rate", lane="paged") == 0.4
