"""The port's batcher observability against the JAX package's at float32:
request tracing, serving metrics and the step ledger of
``PagedContinuousBatcher`` (kubegpu_tpu_torch/models/paging.py,
models/serving.py).

One schedule — staggered submits, a shared prefix (and a full-prefix
hit), a zero budget, a budget of one, a queued cancel, a mid-decode
cancel, budgets cut short by EOS — runs through a JAX and a port
batcher, each with its own ``Tracer`` and ``Metrics``.  Expected: equal
token streams; ``ledger_rows()`` equal row for row on every column but
the timing ones (``t``, ``host_ms``, ``device_ms``) — the pool byte
columns included, since both pools rest the same bytes; equal
``prefix_cache_stats()``; equal ``stats``, the migration counters
included; for every request
the same span names in the same tree shape with one ``retire`` of the
same reason, and no ``serve_retire_violations``; equal histogram counts
of ``serve_ttft_seconds``, ``serve_itl_seconds`` and
``serve_phase_seconds{phase}``, equal counters and gauges — among them
the station's busy slots after every step, the seal-time requant count
and the draft ring's rows and bytes.  The same holds
with ``speculate_k=2``, over an int8 pool with quantized sealing, and
with the synchronous loop; ``trace_shutdown`` closes every live
request's subtree with a ``died`` retire in both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu.utils.tracing import (
    Tracer as JaxTracer,
    serve_retire_violations,
    validate_trace,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.utils.metrics import Metrics
from kubegpu_tpu_torch.utils.tracing import Tracer

# tests/test_http_data_plane.py's tiny replica
TINY = dict(vocab_size=61, num_layers=1, num_heads=2, hidden=16, max_seq=48)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
BATCHER_KW = dict(slots=3, prompt_pad=12, page_size=4, pool_pages=32,
                  token_budget=12)
EOS_ID = 29
CANCEL_QUEUED = 6    # cancelled right after its submit, still queued
CANCEL_LIVE = 2      # cancelled mid-decode, after its second token
TIMING = ("t", "host_ms", "device_ms")

MODES = {
    "plain": {},
    "synchronous": dict(pipeline_decode=False),
    "speculative": dict(speculate_k=2),
    # the JAX batcher requantizes a retirement's sealed pages in one
    # bucket of at most prompt_pad // page pages
    # (kubegpu_tpu/models/paging.py:1739-1747), so this case widens the
    # station to 8 pages: the schedule's longest stream seals 7
    "int8-pool": dict(kv_dtype="int8", decode_page_cache="quantized",
                      prompt_pad=32),
}


@pytest.fixture(scope="module")
def weights():
    target = TransformerLM(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    draft = TransformerLM(
        vocab_size=TINY["vocab_size"], max_seq=TINY["max_seq"],
        num_layers=1, num_heads=2, hidden=16, dtype=jnp.float32,
    ).init(jax.random.PRNGKey(7), jnp.ones((1, 4), jnp.int32))["params"]

    def to_torch(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree))

    return target, draft, to_torch(target), to_torch(draft)


def schedule():
    """Nine requests in three waves.  Requests 0, 3 and 5 share a
    two-page prefix; 5 is exactly that prefix plus one token, a full
    prefix hit with no chunk to run.  Request 4 has a zero budget, 7 a
    budget of one."""
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 61, size=8).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.randint(0, 61, size=3)]),
        rng.randint(0, 61, size=10),
        rng.randint(0, 61, size=6),
        np.concatenate([shared, rng.randint(0, 61, size=2)]),
        rng.randint(0, 61, size=4),
        np.concatenate([shared, rng.randint(0, 61, size=1)]),
        rng.randint(0, 61, size=5),
        rng.randint(0, 61, size=7),
        rng.randint(0, 61, size=9),
    ]
    budgets = [14, 9, 20, 12, 0, 10, 8, 1, 16]
    waves = [(0, 1, 2), (3, 4, 5, 6), (7, 8)]
    return [p.astype(np.int32) for p in prompts], budgets, waves


def build(weights, mode, side):
    jt, jd, tt, td = weights
    kw = dict(TINY, **dict(BATCHER_KW, **MODES[mode]), eos_id=EOS_ID)
    spec = "speculate_k" in kw
    if side == "jax":
        metrics, tracer = JaxMetrics(), JaxTracer()
        cb = JaxPagedContinuousBatcher(
            jt, dtype=jnp.float32, metrics=metrics, tracer=tracer,
            **(dict(draft_params=jd, **DRAFT) if spec else {}), **kw)
    else:
        metrics, tracer = Metrics(), Tracer()
        cb = PagedContinuousBatcher(
            tt, dtype=torch.float32, metrics=metrics, tracer=tracer,
            device="cpu", **(dict(draft_params=td, **DRAFT) if spec else {}),
            **kw)
    return cb, metrics, tracer


def drive(cb, stop_after=None, busy=None):
    """Serve the schedule: each wave is submitted two iterations after
    the one before it; the queued cancel lands right after its submit,
    the live cancel after the request's second token.  ``stop_after``
    stops serving after that many iterations (the shutdown case);
    ``busy`` collects the ``serve_station_slots_busy`` gauge after every
    iteration."""
    prompts, budgets, waves = schedule()
    done, cut, it = {}, None, 0
    pending_waves = list(waves)
    while pending_waves or cb.has_work():
        if pending_waves and it % 2 == 0:
            for i in pending_waves.pop(0):
                cb.submit(i, prompts[i], budgets[i])
                if i == CANCEL_QUEUED:
                    assert cb.cancel(CANCEL_QUEUED)
        if cb.has_work():
            done.update(cb.serve_step())
            if busy is not None:
                busy.append(cb.metrics.gauge("serve_station_slots_busy"))
        live = cb.live_tokens()
        if cut is None and len(live.get(CANCEL_LIVE, [])) >= 2:
            cut = list(live[CANCEL_LIVE])
            assert cb.cancel(CANCEL_LIVE)
        it += 1
        if stop_after is not None and it >= stop_after:
            break
    return done, cut


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


def traces_by_seq(tracer):
    out = {}
    for spans in tracer.completed():
        root = next(s for s in spans if s["parent"] is None)
        assert root["name"] == "serve"
        out[root["attrs"]["seq_id"]] = spans
    return out


def test_schedule_reaches_every_path(weights):
    """The schedule exercises what it claims on the JAX batcher: EOS
    ends a request early, the live cancel cuts one, the full-prefix hit
    runs no chunk."""
    cb, _, tracer = build(weights, "plain", "jax")
    done, cut = drive(cb)
    _, budgets, _ = schedule()
    assert cut is not None and len(cut) >= 2
    assert CANCEL_QUEUED not in done and CANCEL_LIVE not in done
    assert any(0 < len(done[i]) < budgets[i] and done[i][-1] == EOS_ID
               for i in done)
    assert done[4] == [] and len(done[7]) == 1
    assert cb.stats["prefix_hit_tokens"] > 0
    full_hit = traces_by_seq(tracer)[5]
    names = [s["name"] for s in full_hit]
    assert "chunk" not in names and "prefill" not in names
    assert "station_wait" in names and "decode" in names


@pytest.mark.parametrize("mode", list(MODES))
def test_observability_matches_jax(weights, mode):
    jb, jm, jtr = build(weights, mode, "jax")
    tb, tm, ttr = build(weights, mode, "torch")
    jbusy, tbusy = [], []
    want, want_cut = drive(jb, busy=jbusy)
    got, got_cut = drive(tb, busy=tbusy)
    assert got == want and got_cut == want_cut
    assert tbusy == jbusy and max(tbusy) > 0
    tb.assert_page_accounting()
    # the ledger, row for row
    jrows, trows = jb.ledger_rows(), tb.ledger_rows()
    assert len(trows) == len(jrows) > 0
    for jr, tr_ in zip(jrows, trows):
        assert set(tr_) == set(jr)
        assert ({k: v for k, v in tr_.items() if k not in TIMING}
                == {k: v for k, v in jr.items() if k not in TIMING})
        assert tr_["host_ms"] >= 0 and tr_["device_ms"] >= 0
    assert tb.ledger_rows(3) == trows[-3:]
    assert tb.prefix_cache_stats() == jb.prefix_cache_stats()
    assert tb.prefix_cache_stats()["chains"] > 0
    if tb.kv_quant:
        assert tb.stats["decode_pages_sealed"] > 0
    assert tb.stats == jb.stats
    # the trace trees
    assert jtr.wait_quiescent(5.0) and ttr.wait_quiescent(5.0)
    jt, tt = traces_by_seq(jtr), traces_by_seq(ttr)
    assert sorted(tt) == sorted(jt) == list(range(9))
    for seq in jt:
        assert shape(tt[seq]) == shape(jt[seq]), seq
        spans = tt[seq]
        assert not validate_trace(spans) + serve_retire_violations(spans)
        assert set(spans[0]) == {"trace", "span", "parent", "name", "start",
                                 "end", "attrs"}
    retire = {seq: next(s["attrs"]["reason"] for s in tt[seq]
                        if s["name"] == "retire") for seq in tt}
    assert retire[CANCEL_QUEUED] == retire[CANCEL_LIVE] == "cancelled"
    assert retire[0] == "finished"
    # the metrics
    for name in ("serve_ttft_seconds", "serve_itl_seconds",
                 "serve_prefill_wait_seconds"):
        assert tm.histogram_count(name) == jm.histogram_count(name), name
    assert tm.histogram_count("serve_ttft_seconds") > 0
    for phase in ("queue", "station_wait", "prefill", "first_step",
                  "decode"):
        assert (tm.histogram_count("serve_phase_seconds", phase=phase)
                == jm.histogram_count("serve_phase_seconds", phase=phase)
                ), phase
    assert tm.histogram_count("serve_phase_seconds", phase="decode") > 0
    for name, labels in (("serve_prompt_tokens_total", {}),
                         ("serve_prefix_hit_tokens_total",
                          {"kind": "prompt"}),
                         ("serve_prefix_hit_tokens_total",
                          {"kind": "decode"}),
                         ("serve_prefill_chunks_total", {}),
                         ("serve_decode_pages_sealed_total", {}),
                         ("serve_kv_quant_seal_requants_total", {}),
                         ("serve_spec_steps_total", {}),
                         ("serve_spec_tokens_per_step", {})):
        assert tm.get(name, **labels) == jm.get(name, **labels), name
    for name, labels in (("serve_tp_devices", {}),
                         ("serve_tp_pool_bytes_per_device", {}),
                         ("serve_pool_kv_bytes",
                          {"dtype": "int8" if tb.kv_quant else "float32"}),
                         ("serve_step_rows", {}),
                         ("serve_pool_pages_free", {}),
                         ("serve_pool_pages_live", {}),
                         ("serve_pool_pages_cached", {}),
                         ("serve_draft_cache_rows", {}),
                         ("serve_draft_ring_bytes", {"dtype": "float32"})):
        assert tm.gauge(name, **labels) == jm.gauge(name, **labels), name
    if tb.kv_quant:
        assert (tm.get("serve_kv_quant_seal_requants_total")
                == tb.stats["seal_requants"] > 0)
    if tb.speculate_k:
        assert tm.get("serve_spec_steps_total") == tb.stats["spec_steps"]
        assert tm.gauge("serve_draft_cache_rows") > 0
        assert tm.gauge("serve_draft_ring_bytes", dtype="float32") > 0
        assert (tm.histogram_count("serve_spec_accept_rate", mode="greedy")
                == jm.histogram_count("serve_spec_accept_rate",
                                      mode="greedy") > 0)
        assert any(s["name"] == "spec_verify" for s in tt[0])
    # first_token_s agrees with the first-token annotation
    for seq, ttft in tb.first_token_s.items():
        decode = next(s for s in tt[seq] if s["name"] == "decode")
        assert decode["attrs"]["measured_ttft"] == pytest.approx(ttft)


@pytest.mark.parametrize("mode", ["plain", "speculative"])
def test_trace_shutdown_retires_every_live_request(weights, mode):
    shapes = {}
    for side in ("jax", "torch"):
        cb, _, tracer = build(weights, mode, side)
        drive(cb, stop_after=5)
        assert cb.has_work()
        cb.trace_shutdown("replica server stopped")
        assert tracer.open_count() == 0
        traces = traces_by_seq(tracer)
        died = {seq for seq, spans in traces.items()
                if any(s["name"] == "retire"
                       and s["attrs"]["reason"] == "died" for s in spans)}
        assert died
        for spans in traces.values():
            assert not validate_trace(spans) + serve_retire_violations(spans)
        shapes[side] = {seq: shape(spans) for seq, spans in traces.items()}
    assert shapes["torch"] == shapes["jax"]
