"""Prefill/decode disaggregation on the port's batcher
(kubegpu_tpu_torch/models/paging.py) against the JAX package, at float32
on the CPU: the mirrors of tests/test_disaggregation.py.

- Parking: a ``prefill_only`` port batcher prefills, seals and parks
  with zero tokens, announces the seal once, and its export resumes
  token-identical in a JAX batcher and in a port batcher; turning the
  mode off unparks it locally.
- The handoff through the JAX gateway over the in-memory data plane,
  with a port prefill replica and a JAX decode replica, and the
  reverse: streamed and one-shot, full-width and int8 pools, speculative
  — every stream equal to the co-located JAX stream.
- Fallback: a refusing decode side resumes decode on the port's prefill
  replica (counted ``fallback``); collapse unparks locally.
- The streamed handoff at batcher level, both ways between the
  packages: deltas ship while the prefill still runs, the exporter
  reclaims the acked pages, the final export ships only the rest, and
  the stream is the co-located one; a refused delta stages nothing and
  a later refusal leaves the staged prefix; early reclaim admits a
  deferred prefill; parked sequences leave the token budget.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy

CFG = dict(vocab_size=64, num_layers=2, num_heads=8, hidden=32, max_seq=64)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]        # 2 exact pages at page_size=4
PROMPT24 = [(i * 7 + 3) % 64 for i in range(24)]   # 6 pages
PROMPT24B = [(i * 5 + 11) % 64 for i in range(24)]
PROMPT24C = [(i * 11 + 7) % 64 for i in range(24)]


@pytest.fixture(scope="module")
def params():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def spec_kw(params, side, k=2):
    jp, tp = params
    return dict(draft_params=jp if side == "jax" else tp, speculate_k=k,
                draft_num_layers=CFG["num_layers"],
                draft_num_heads=CFG["num_heads"], draft_hidden=CFG["hidden"])


def make(params, side, spec=False, **kw):
    jp, tp = params
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_pad", 16)
    kw.setdefault("page_size", 4)
    kw.setdefault("pool_pages", 48)
    kw.setdefault("decode_page_cache", "fp32")
    if spec:
        kw.update(spec_kw(params, side))
    if side == "jax":
        return JaxPagedContinuousBatcher(jp, dtype=jnp.float32, **CFG, **kw)
    return PagedContinuousBatcher(tp, dtype=torch.float32, device="cpu",
                                  **CFG, **kw)


def jax_ref(params, prompt, budget, **kw):
    return make(params, "jax", **kw).run(
        [np.asarray(prompt, np.int32)], [budget])[0]


def drain(cb):
    out = {}
    while cb.has_work():
        out.update(cb.serve_step())
    return out


def park(cb, seq_id, prompt, budget, timeout=60):
    cb.submit(seq_id, np.asarray(prompt, np.int32), budget)
    deadline = time.monotonic() + timeout
    sealed = []
    while not sealed:
        assert time.monotonic() < deadline, "prefill never parked"
        cb.serve_step()
        sealed = cb.drain_sealed()
    return sealed


# ---------------------------------------------------------------------------
# parking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dst_side", ["torch", "jax"])
def test_port_prefill_only_parks_at_seal(params, dst_side):
    ref = jax_ref(params, PROMPT, 10)
    src = make(params, "torch", prefill_only=True)
    assert park(src, 1, PROMPT, 10) == [1]
    assert src.drain_sealed() == []          # announced once
    s = next(s for s in src._seqs if s.seq_id == 1)
    assert s.parked and s.tokens == [] and not bool(src._active_dev[0])
    for _ in range(3):                       # parked: no step runs it
        src.serve_step()
    assert src.live_tokens() == {1: []}
    payload = src.export_pages(1)
    src.cancel(1)
    src.assert_page_accounting()
    dst = make(params, dst_side)
    dst.import_pages(11, payload)
    assert drain(dst)[11] == ref
    dst.assert_page_accounting()
    # the collapse leg: park again, then unpark locally
    park(src, 2, PROMPT, 10)
    assert src.set_prefill_only(False)
    assert drain(src)[2] == ref
    src.assert_page_accounting()


def test_imported_sequence_decodes_on_a_prefill_replica(params):
    """The fallback resume: re-imported into the prefill-only batcher it
    came from, the sequence decodes instead of parking again."""
    ref = jax_ref(params, PROMPT, 8)
    src = make(params, "torch", prefill_only=True)
    park(src, 1, PROMPT, 8)
    payload = src.export_pages(1)
    src.cancel(1)
    src.import_pages(9, payload)
    assert drain(src)[9] == ref
    src.assert_page_accounting()


# ---------------------------------------------------------------------------
# the gateway handoff over the in-memory data plane
# ---------------------------------------------------------------------------

def _disagg_stack(params, prefill_side, decode_side, paged_kw,
                  dispatchers=2):
    """Two replicas, roles (prefill, flex): the prefill role gets a
    ``prefill_side`` batcher, the other a ``decode_side`` one."""
    from kubegpu_tpu.gateway import (
        AdmissionQueue, FailoverPolicy, Gateway, InMemoryReplicaClient,
    )
    from kubegpu_tpu.testing.fake_serving import build_fake_serving_stack
    from kubegpu_tpu.utils.metrics import Metrics

    stack = build_fake_serving_stack(2, metrics=Metrics(),
                                     roles=("prefill", "flex"))

    def factory(key):
        side = (prefill_side if stack.registry.get(key).role == "prefill"
                else decode_side)
        return make(params, side, **paged_kw)

    client = InMemoryReplicaClient(batcher_factory=factory,
                                   step_delay_s=0.0)
    stack.registry.subscribe(client.sync_live)
    gw = Gateway(
        stack.registry, client, queue=AdmissionQueue(capacity=32),
        policy=FailoverPolicy(deadline_s=120.0, hedge_after_s=60.0,
                              max_attempts=4),
        metrics=Metrics(), dispatchers=dispatchers,
    )
    stack.registry.refresh()
    for rep in stack.registry.live():
        if rep.role == "prefill":
            client.set_role(rep.key, "prefill")
    gw.start()
    return stack, client, gw


def _batchers(client):
    with client._lock:
        return {k: w.batcher for k, w in client._workers.items()}


def _pools_balanced(client):
    for b in _batchers(client).values():
        b.assert_page_accounting()


IDENTITY = {
    "fp32": (dict(), PROMPT, True),
    "fp32-oneshot": (dict(), PROMPT, False),
    "int8": (dict(kv_dtype="int8", decode_page_cache="quantized"), PROMPT,
             True),
    "speculative": (dict(spec=True), PROMPT, True),
}


@pytest.mark.parametrize("prefill_side,decode_side",
                         [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("case", list(IDENTITY))
def test_disaggregated_identity_across_packages(params, case, prefill_side,
                                                decode_side):
    from kubegpu_tpu.gateway import GatewayRequest

    paged_kw, prompt, streamed = IDENTITY[case]
    ref = jax_ref(params, prompt, 10, **paged_kw)
    stack, client, gw = _disagg_stack(params, prefill_side, decode_side,
                                      paged_kw)
    try:
        if not streamed:
            gw.dispatcher.stream_handoff = False
        p = gw.submit(GatewayRequest(prompt=list(prompt), max_new_tokens=10,
                                     request_id="d0"))
        assert p.wait(180), "disaggregated request timed out"
        r = p.result()
        assert r.status == "ok", (r.status, r.error)
        assert list(r.tokens) == ref
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="ok") == 1
        deltas = gw.metrics.get("gateway_phase_handoff_deltas_total")
        assert (deltas >= 1) if streamed else (deltas == 0)
        pre = next(b for k, b in _batchers(client).items()
                   if stack.registry.get(k).role == "prefill")
        dec = next(b for k, b in _batchers(client).items()
                   if stack.registry.get(k).role != "prefill")
        assert dec.stats["imports"] == 1 and dec.stats["pages_imported"] > 0
        if streamed:
            assert pre.stats["pages_reclaimed"] >= 1
        assert gw.drain(60)
        _pools_balanced(client)
    finally:
        gw.stop()
        client.stop()


def test_refusal_falls_back_to_the_port_prefill_replica(params):
    from kubegpu_tpu.gateway import GatewayRequest

    ref = jax_ref(params, PROMPT, 10)
    stack, client, gw = _disagg_stack(params, "torch", "jax", {})
    try:
        for rep in stack.registry.live():
            if rep.role != "prefill":
                client.set_fail_migration(rep.key, True)
        p = gw.submit(GatewayRequest(prompt=PROMPT, max_new_tokens=10,
                                     request_id="fb0"))
        assert p.wait(180)
        r = p.result()
        assert r.status == "ok", (r.status, r.error)
        assert list(r.tokens) == ref
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="fallback") == 1
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="ok") == 0
        assert gw.drain(60)
        _pools_balanced(client)
    finally:
        gw.stop()
        client.stop()


def test_collapse_unparks_locally(params):
    from kubegpu_tpu.gateway import GatewayRequest

    ref = jax_ref(params, PROMPT, 10)
    stack, client, gw = _disagg_stack(params, "torch", "torch", {})
    try:
        gw.set_disaggregation(False)
        p = gw.submit(GatewayRequest(prompt=PROMPT, max_new_tokens=10,
                                     request_id="c0"))
        assert p.wait(180)
        r = p.result()
        assert r.status == "ok", (r.status, r.error)
        assert list(r.tokens) == ref
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="ok") == 0
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="fallback") == 1
        assert gw.drain(60)
        _pools_balanced(client)
    finally:
        gw.stop()
        client.stop()


# ---------------------------------------------------------------------------
# the streamed handoff at batcher level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src_side,dst_side",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
def test_delta_pipeline_identity(params, src_side, dst_side):
    ref = jax_ref(params, PROMPT24, 6, prompt_pad=32)
    src = make(params, src_side, prompt_pad=32, prefill_only=True)
    dst = make(params, dst_side, prompt_pad=32)
    src.submit(1, np.asarray(PROMPT24, np.int32), 6)
    cursor = deltas = 0
    deadline = time.monotonic() + 60
    sealed = []
    while not sealed:
        assert time.monotonic() < deadline, "prefill never parked"
        src.serve_step()
        sealed = src.drain_sealed()
        d = src.export_sealed_delta(1, cursor)
        if d is not None and d["page_keys"]:
            assert dst.import_sealed_delta(d) == len(d["page_keys"])
            cursor += len(d["page_keys"])
            deltas += 1
            src.assert_page_accounting()
            dst.assert_page_accounting()
    assert deltas >= 2, "one-page chunks must yield several deltas"
    freed = src.reclaim_handoff_pages(1, cursor)
    assert freed >= 1 and src.stats["pages_reclaimed"] == freed
    src.assert_page_accounting()
    payload = src.export_pages(1, cursor)
    assert payload["layer_base"] == cursor
    src.cancel(1)
    src.assert_page_accounting()
    dst.import_pages(11, payload)
    assert drain(dst)[11] == ref
    dst.assert_page_accounting()


def test_delta_refusal_rolls_back_atomically(params):
    src = make(params, "torch", prompt_pad=32, prefill_only=True)
    park(src, 1, PROMPT24, 4)
    payload = src.export_sealed_delta(1, 0)
    assert len(payload["page_keys"]) == 5    # (24 - 1) // 4 sealed pages
    assert payload["sealed"] is True
    # the pool cannot hold the delta: refused before any allocation
    tiny = make(params, "torch", prompt_pad=32, pool_pages=4)
    free_before = set(tiny.free_pages)
    with pytest.raises(RuntimeError):
        tiny.import_sealed_delta(payload)
    assert set(tiny.free_pages) == free_before
    for keyhex in payload["page_keys"]:
        assert tiny.prefix_cache.lookup(bytes.fromhex(keyhex)) is None
    assert tiny.stats["pages_imported"] == 0
    tiny.assert_page_accounting()
    # a refusal after a successful stage leaves the staged prefix
    dst = make(params, "torch", prompt_pad=32)
    assert dst.import_sealed_delta(payload) == 5
    bad = dict(payload, geometry=dict(payload["geometry"], page=8))
    with pytest.raises(ValueError):
        dst.import_sealed_delta(bad)
    for keyhex in payload["page_keys"]:
        assert dst.prefix_cache.lookup(bytes.fromhex(keyhex)) is not None
    dst.assert_page_accounting()
    # a JAX importer stages the port's delta too
    jdst = make(params, "jax", prompt_pad=32)
    assert jdst.import_sealed_delta(payload) == 5
    jdst.assert_page_accounting()
    src.cancel(1)
    src.assert_page_accounting()


def test_early_reclaim_admits_queued_prefill(params):
    src = make(params, "torch", prompt_pad=24, pool_pages=10,
               prefill_only=True)
    park(src, 1, PROMPT24, 4)                # 7 pages
    src.submit(2, np.asarray(PROMPT24B, np.int32), 4)
    for _ in range(10):
        src.serve_step()
    assert src.drain_sealed() == [], "admitted despite pool pressure"
    assert src.reclaim_handoff_pages(1, 5) == 5
    src.assert_page_accounting()
    deadline = time.monotonic() + 60
    sealed = []
    while not sealed:
        assert time.monotonic() < deadline
        src.serve_step()
        sealed = src.drain_sealed()
    assert sealed == [2]
    src.assert_page_accounting()
    # a reclaimed slot stays parked through a collapse
    src.set_prefill_only(False)
    assert next(s for s in src._seqs if s.seq_id == 1).parked
    src.cancel(1)
    src.cancel(2)
    src.assert_page_accounting()


def test_parked_sequences_excluded_from_token_budget(params):
    b = make(params, "torch", prompt_pad=32, prefill_only=True,
             token_budget=9)
    park(b, 1, PROMPT24, 4)
    b.import_pages(9, b.export_pages(1))     # the one real decoder
    b.submit(2, np.asarray(PROMPT24B, np.int32), 4)
    b.submit(3, np.asarray(PROMPT24C, np.int32), 4)
    deadline = time.monotonic() + 60
    while len(b._jobs) < 2:
        assert time.monotonic() < deadline, "prefill jobs never opened"
        b.serve_step()
    before = b.stats["prefill_chunks"]
    b.serve_step()
    assert b.stats["prefill_chunks"] - before == 2
    for seq in (1, 2, 3, 9):
        b.cancel(seq)
    b.assert_page_accounting()
