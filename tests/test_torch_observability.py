"""The port's observability copies against the JAX package's: the
metrics registry (kubegpu_tpu_torch/utils/metrics.py), request tracing
(utils/tracing.py) and the metric catalog (utils/metric_names.py).

- The same calls render byte-identical Prometheus text in both
  ``Metrics`` classes (a fixed clock makes ``timer`` deterministic).
- The same span calls give the same span dicts in both ``Tracer``
  classes, and the port's spans, grafted by the JAX ``Tracer.graft``
  under a gateway's dispatch span, pass the JAX ``validate_trace`` and
  ``serve_retire_violations``.
- The catalog lint of tests/test_metrics_catalog.py over
  ``kubegpu_tpu_torch/``: every name the port emits is in the port's
  catalog, every catalog entry is emitted, and each entry equals the
  JAX ``CATALOG`` entry of the same name."""

import itertools
import re
import time
from pathlib import Path

import pytest

from kubegpu_tpu.utils import metrics as jax_metrics
from kubegpu_tpu.utils import tracing as jax_tracing
from kubegpu_tpu.utils.metric_names import CATALOG as JAX_CATALOG
from kubegpu_tpu_torch.utils import metrics as port_metrics
from kubegpu_tpu_torch.utils import tracing as port_tracing
from kubegpu_tpu_torch.utils.metric_names import CATALOG, MetricSpec

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubegpu_tpu_torch"

# tests/test_metrics_catalog.py's emission pattern: .inc( / .observe( /
# .set_gauge( / .timer( with a string-literal first argument
_EMIT_RE = re.compile(
    r"\.(?:inc|observe|set_gauge|timer)\(\s*[\"']([a-z0-9_]+)[\"']",
    re.S,
)

# the names the port's replica path and its extender emit
WANT_NAMES = {
    "replica_http_requests_total", "replica_http_stream_events_total",
    "replica_http_streams_active", "replica_http_cancels_total",
    "replica_http_disconnect_cancels_total",
    "replica_http_expired_refusals_total",
    "replica_stream_fastforward_tokens_total",
    "serve_ttft_seconds", "serve_itl_seconds", "serve_phase_seconds",
    "serve_prefill_wait_seconds", "serve_prompt_tokens_total",
    "serve_prefix_hit_tokens_total", "serve_prefill_chunks_total",
    "serve_decode_pages_sealed_total", "serve_step_host_ms",
    "serve_step_device_ms", "serve_step_rows", "serve_pool_pages_free",
    "serve_pool_pages_live", "serve_pool_pages_cached",
    "serve_spec_steps_total", "serve_spec_tokens_per_step",
    "serve_spec_accept_rate", "serve_spec_draft_seconds",
    "serve_spec_verify_seconds", "serve_pool_kv_bytes", "serve_tp_devices",
    "serve_tp_pool_bytes_per_device",
    # the four series the batcher's station, seal-time requantization
    # and draft ring report
    "serve_station_slots_busy", "serve_kv_quant_seal_requants_total",
    "serve_draft_cache_rows", "serve_draft_ring_bytes",
    # the migration verbs' series (gateway/dataplane.py) and the streamed
    # handoff's early reclaim (models/paging.py)
    "replica_migrate_pages_total", "replica_migrate_seconds",
    "replica_migrate_wire_bytes_total",
    "serve_handoff_pages_reclaimed_total",
    # the measured-quality gauges (models/serving.py's
    # record_quant_quality and record_sampling_quality)
    "serve_kv_quant_agreement", "serve_kv_quant_divergence_margin",
    "serve_kv_quant_ppl_delta", "serve_sampled_accept_rate",
    "serve_sampled_nll_delta", "serve_sampled_unigram_agreement",
    # tensor-parallel serving's modeled all-reduce bytes (models/paging.py
    # over a mesh)
    "serve_tp_collective_bytes_total",
    # the scheduler extender's series (scheduler/core.py)
    "kubegpu_filter_total", "kubegpu_filter_seconds",
    "kubegpu_prioritize_total", "kubegpu_prioritize_seconds",
    "kubegpu_bind_total", "kubegpu_bind_seconds",
    "kubegpu_bind_conflicts_total", "kubegpu_chips_allocated_total",
    "kubegpu_grouped_allocated_total", "kubegpu_placements_total",
    "kubegpu_placements_contiguous_total", "kubegpu_preemptions_total",
    "kubegpu_preempted_pods_total", "kubegpu_stranded_gang_rollbacks_total",
    "kubegpu_health_evictions_total",
}


@pytest.fixture
def clock(monkeypatch):
    """A deterministic ``time.monotonic`` for both packages' modules;
    calling the fixture's value restarts it."""
    ticks = [itertools.count(1)]
    monkeypatch.setattr(time, "monotonic", lambda: next(ticks[0]) * 0.125)

    def restart():
        ticks[0] = itertools.count(1)

    return restart


def emitted_names():
    names = {}
    for path in sorted(PKG.rglob("*.py")):
        for m in _EMIT_RE.finditer(path.read_text()):
            names.setdefault(m.group(1), set()).add(
                str(path.relative_to(REPO)))
    return names


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _fill(m, n_obs: int):
    m.inc("serve_prompt_tokens_total", 12)
    m.inc("serve_prefix_hit_tokens_total", 8, kind="prompt")
    m.inc("serve_prefix_hit_tokens_total", 4, kind="decode")
    m.inc("replica_http_requests_total", verb="submit")
    m.inc("replica_http_requests_total", verb='odd"verb\\with\nbreaks')
    m.set_gauge("serve_step_rows", 7.0)
    m.set_gauge("serve_pool_kv_bytes", 4096.0, dtype="int8")
    m.set_gauge("serve_pool_kv_bytes", 256.0, dtype="float32")
    m.set_gauge("serve_step_rows", 5.0)
    for i in range(n_obs):
        m.observe("serve_itl_seconds", (i * 37 % 101) / 7.0)
    m.observe("serve_phase_seconds", 0.25, phase="queue")
    m.observe("serve_phase_seconds", 1.5, phase="decode")
    with m.timer("serve_spec_draft_seconds"):
        pass
    with m.timer("serve_phase_seconds", phase="prefill"):
        pass


@pytest.mark.parametrize("n_obs", [0, 3, 1500])
def test_metrics_render_byte_identical(clock, n_obs):
    jm, pm = jax_metrics.Metrics(), port_metrics.Metrics()
    _fill(jm, n_obs)
    clock()
    _fill(pm, n_obs)
    assert pm.render() == jm.render()
    assert pm.render().count("# TYPE serve_phase_seconds summary") == 1
    for name, labels in (("serve_itl_seconds", {}),
                         ("serve_phase_seconds", {"phase": "queue"}),
                         ("serve_spec_draft_seconds", {})):
        assert (pm.histogram_count(name, **labels)
                == jm.histogram_count(name, **labels))
        assert (pm.histogram_sum(name, **labels)
                == jm.histogram_sum(name, **labels))
        for q in (0.0, 0.5, 0.99):
            assert (pm.quantile(name, q, **labels)
                    == jm.quantile(name, q, **labels))
    assert pm.get("serve_prefix_hit_tokens_total", kind="decode") == 4
    assert pm.gauge("serve_step_rows") == jm.gauge("serve_step_rows") == 5.0


def test_label_escaping_matches():
    for value in ('a"b', "a\\b", "a\nb", "plain", 7):
        assert (port_metrics.escape_label_value(value)
                == jax_metrics.escape_label_value(value))


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _spans_of(mod, leak_guard: bool):
    """One replica request's tree, built through a package's Tracer:
    root, a serve subtree with phases, a point event, annotations, an
    idempotent double end, a span opened after its trace completed
    (inert), and the leak guard force-closing an old open trace."""
    tr = mod.Tracer(max_traces=8, max_open=2 if leak_guard else 64)
    root = tr.start_trace("replica_request", request_id="r1",
                          remote_trace="t00000001", remote_span=3)
    serve = root.child("serve", seq_id=0, plen=5, max_new=4)
    queue = serve.child("queue")
    queue.end()
    queue.end()                               # idempotent
    decode = serve.child("decode")
    decode.annotate(first_token_t=42.0, measured_ttft=1.5)
    decode.child("spec_draft", k=2).end()
    decode.end()
    serve.event("retire", reason="finished", n_tokens=4)
    serve.end()
    root.end(status="done")
    late = root.child("late")                 # trace already complete
    late.end()
    if leak_guard:
        tr.start_trace("leaked_a").child("open")
        tr.start_trace("leaked_b")
        tr.start_trace("leaked_c")
    return tr


@pytest.mark.parametrize("leak_guard", [False, True])
def test_tracer_span_dicts_match(clock, leak_guard):
    jt = _spans_of(jax_tracing, leak_guard)
    clock()
    pt = _spans_of(port_tracing, leak_guard)
    assert pt.completed() == jt.completed()
    assert (pt.open_count(), pt.aborted, pt.evicted) == (
        jt.open_count(), jt.aborted, jt.evicted)
    tid = pt.completed()[0][0]["trace"]
    assert pt.trace(tid) == jt.trace(tid)
    for s in pt.trace(tid):
        assert set(s) == {"trace", "span", "parent", "name", "start", "end",
                          "attrs"}
        assert isinstance(s["start"], float) and isinstance(s["end"], float)
    assert not pt.wait_quiescent(0.0) if leak_guard else pt.wait_quiescent(
        1.0)


def test_port_spans_graft_into_a_jax_gateway_trace():
    port = port_tracing.Tracer()
    root = port.start_trace("replica_request", request_id="g")
    serve = root.child("serve", seq_id=0, plen=3, max_new=2)
    serve.child("queue").end()
    decode = serve.child("decode")
    decode.child("spec_verify", accepted=1, emitted=2).end()
    decode.end()
    serve.event("retire", reason="finished", n_tokens=2)
    serve.end()
    root.end(status="done")
    spans = port.trace(root.trace_id)
    gw = jax_tracing.Tracer()
    groot = gw.start_trace("gateway_request", request_id="g")
    dispatch = groot.child("dispatch", replica="torch")
    # the gateway anchors the remote clock at its dispatch stamp
    offset = dispatch.start - min(s["start"] for s in spans)
    t_end = max(s["end"] for s in spans) + offset
    assert gw.graft(dispatch, spans, offset=offset) == len(spans)
    dispatch.end(t=t_end)
    groot.end(t=t_end)
    tree = gw.trace(groot.trace_id)
    assert not jax_tracing.validate_trace(tree)
    assert not jax_tracing.serve_retire_violations(tree)
    by_id = {s["span"]: s for s in tree}
    grafted_serve = next(s for s in tree if s["name"] == "serve")
    assert grafted_serve["attrs"]["remote"] is True
    assert by_id[grafted_serve["parent"]]["name"] == "replica_request"
    assert (by_id[by_id[grafted_serve["parent"]]["parent"]]["name"]
            == "dispatch")


def test_port_tracer_grafts_like_jax(clock):
    """The port keeps the graft too (a foreign trace under a local
    span): the same remote dicts graft to the same local dicts."""
    remote = [
        {"trace": "x", "span": 10, "parent": None, "name": "serve",
         "start": 1.0, "end": 2.0, "attrs": {}},
        {"trace": "x", "span": 11, "parent": 10, "name": "queue",
         "start": 1.0, "end": None, "attrs": {"k": 1}},
        {"trace": "x", "span": 12, "parent": 99, "name": "orphan",
         "start": 1.5, "end": 1.6, "attrs": {}},
    ]
    out = []
    for mod in (jax_tracing, port_tracing):
        clock()
        tr = mod.Tracer()
        root = tr.start_trace("gw")
        assert tr.graft(root, remote, offset=0.5) == 3
        root.end()
        out.append(tr.completed())
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

def test_every_emitted_name_is_cataloged():
    names = emitted_names()
    missing = {n: sorted(p) for n, p in names.items() if n not in CATALOG}
    assert not missing, missing


def test_every_catalog_entry_is_emitted_and_equals_the_reference():
    names = emitted_names()
    assert set(CATALOG) == WANT_NAMES
    assert not set(CATALOG) - set(names), sorted(set(CATALOG) - set(names))
    for name, spec in CATALOG.items():
        assert isinstance(spec, MetricSpec)
        assert tuple(spec) == tuple(JAX_CATALOG[name]), name
        assert spec.type in ("counter", "gauge", "histogram")
