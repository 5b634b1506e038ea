"""The catalog of every metric name the port emits: its own copy of the
entries of the JAX package's ``utils/metric_names.py`` for the names the
port's replica serving path emits, with the same kind, label keys and
help text, so dashboards read a torch replica exactly as a JAX one.

``tests/test_torch_observability.py`` greps ``kubegpu_tpu_torch/`` for
``inc(``/``observe(``/``set_gauge(``/``timer(`` string literals and
fails on a name missing here, on a catalog entry no code emits, and on
an entry that differs from the reference's.  The names of slices still
to come (the int8 pool's quality gauges, tensor-parallel collectives)
arrive with those slices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class MetricSpec(NamedTuple):
    type: str                    # "counter" | "gauge" | "histogram"
    labels: Tuple[str, ...]      # label KEYS the emitting sites attach
    help: str


def _c(labels: Tuple[str, ...], help: str) -> MetricSpec:
    return MetricSpec("counter", labels, help)


def _g(labels: Tuple[str, ...], help: str) -> MetricSpec:
    return MetricSpec("gauge", labels, help)


def _h(labels: Tuple[str, ...], help: str) -> MetricSpec:
    return MetricSpec("histogram", labels, help)


CATALOG: Dict[str, MetricSpec] = {
    # -- replica HTTP serving endpoint (gateway/dataplane.py)
    "replica_http_requests_total": _c(
        ("verb",), "replica endpoint requests by verb "
        "(submit/cancel/state/get)"),
    "replica_http_stream_events_total": _c(
        (), "SSE data events written to submit streams "
        "(tokens/done/error; pings not counted)"),
    "replica_http_streams_active": _g(
        (), "submit streams currently open (one per in-flight remote "
        "request)"),
    "replica_http_cancels_total": _c(
        (), "sequences cancelled wire-level (/v1/cancel, or a "
        "duplicate-id eviction)"),
    "replica_http_disconnect_cancels_total": _c(
        (), "sequences cancelled because their stream's client "
        "vanished mid-stream (disconnect ⇒ cancel; pages freed)"),
    "replica_migrate_pages_total": _c(
        ("dir",), "KV pages moved through the migration verbs by "
        "direction (export: serialized out of this pool; import: "
        "written into it)"),
    "replica_migrate_seconds": _h(
        ("dir",), "wall time of one export/import verb (serialize + "
        "detach, or allocate + chain-replay + resume)"),
    "replica_migrate_wire_bytes_total": _c(
        ("dir",), "encoded transfer payload bytes through the "
        "migration verbs by direction"),
    "replica_http_expired_refusals_total": _c(
        (), "admissions the replica refused because the remaining "
        "deadline the gateway shipped on the wire elapsed while the "
        "request queued in the serving loop's inbox (shed-before-work, "
        "replica side: no prefill burned for an abandoned caller)"),
    "replica_stream_fastforward_tokens_total": _c(
        (), "tokens a submit's resume watermark told this replica NOT "
        "to emit (the caller already has them — hedge twins and "
        "gateway-failover resumes decode them but fast-forward "
        "emission)"),

    # -- per-request timings (models/serving.py, models/paging.py)
    "serve_ttft_seconds": _h((), "submit -> first generated token"),
    "serve_itl_seconds": _h((), "inter-token latency between emits"),
    "serve_phase_seconds": _h(
        ("phase",), "per-request phase wall time from the span tree "
        "(queue/station_wait/prefill/first_step/decode); emitted only "
        "when tracing is enabled"),
    "serve_prefill_wait_seconds": _h(
        (), "submit -> first prefill chunk (station wait included)"),
    "serve_station_slots_busy": _g(
        (), "prefill-station slots occupied by in-flight admissions"),

    # -- token and chunk counters (models/paging.py)
    "serve_prompt_tokens_total": _c((), "prompt tokens admitted"),
    "serve_prefix_hit_tokens_total": _c(
        ("kind",), "prompt tokens skipped via prefix-cache hits, split "
        "by hit-page kind (prompt/decode); labeled series only — sum "
        "over the label for the total"),
    "serve_prefill_chunks_total": _c((), "prefill chunk programs run"),
    "serve_decode_pages_sealed_total": _c(
        (), "decode-produced pages sealed into the prefix cache at "
        "retirement"),
    "serve_handoff_pages_reclaimed_total": _c(
        (), "prompt pages freed EARLY on a parked prefill replica — "
        "acked by the decode side's staged deltas, released before the "
        "final handoff roundtrip (each reclaim raises prefill admission "
        "headroom mid-schedule)"),
    "serve_kv_quant_seal_requants_total": _c(
        (), "pool pages run through seal-time requantization before "
        "entering the shared prefix chain (int8 pool: stretch int8 "
        "range back to 127, shrink the scale — recovers precision a "
        "rejected speculative row's grow-and-rescale inflation "
        "squeezed out; a no-op for already-tight pages)"),
    "serve_kv_quant_agreement": _g(
        (), "measured token agreement of the int8 pool vs the "
        "full-width pool on identical traffic (bench.py "
        "serving_quantized_pool; models/serving.record_quant_quality)"),
    "serve_kv_quant_divergence_margin": _g(
        (), "top1-top2 logit margin at the first int8-vs-full-width "
        "token divergence (near-tie ⇒ the expected quantization "
        "rounding class; a wide margin would mean a real bug)"),
    "serve_kv_quant_ppl_delta": _g(
        (), "teacher-forced eval NLL delta of the int8-pool stream vs "
        "the full-width pool's (the eval_ppl_delta_int8 discipline "
        "applied to the page pool)"),

    # -- sampled-speculation quality (models/serving.py
    #    record_sampling_quality): per-position acceptance plus
    #    distribution-agreement evidence for lossless rejection sampling
    "serve_sampled_accept_rate": _g(
        ("lane",), "mean accepted-draft fraction of the sampled-"
        "speculation bench lane ((emitted-1)/k averaged over verifies); "
        "lane=dense (slot batcher) or lane=paged (page-pool batcher)"),
    "serve_sampled_nll_delta": _g(
        ("lane",), "teacher-forced target-model NLL of the spec-sampled "
        "streams minus the plain-sampled streams' (same seeds; ~0 "
        "within sampling noise when rejection sampling is lossless); "
        "lane=dense|paged"),
    "serve_sampled_unigram_agreement": _g(
        ("lane",), "L1 overlap of the unigram token histograms of the "
        "spec-sampled vs plain-sampled streams (1.0 = identical "
        "marginal distributions; a distribution-level lossless check); "
        "lane=dense|paged"),

    # -- speculation (models/paging.py with speculate_k)
    "serve_spec_steps_total": _c((), "speculative verify iterations"),
    "serve_spec_tokens_per_step": _c(
        (), "tokens committed by speculative verifies (divide by "
        "serve_spec_steps_total for the per-step mean)"),
    "serve_spec_accept_rate": _h(
        ("mode",), "accepted-draft fraction per slot per verify "
        "(e-1)/k; mode=greedy (exact-match verify) or mode=sampled "
        "(rejection-sampled lossless speculation)"),
    "serve_spec_draft_seconds": _h((), "draft proposal program wall time"),
    "serve_spec_verify_seconds": _h((), "verify program wall time"),
    "serve_draft_cache_rows": _g(
        (), "draft ring-cache rows resident (slots x draft_window)"),
    "serve_draft_ring_bytes": _g(
        ("dtype",), "draft ring-cache bytes RESTING by storage dtype "
        "(mesh-wide aggregate, like serve_pool_kv_bytes).  A quantized "
        "ring (kv_dtype=\"int8\") reports two series — int8 row bytes "
        "and float32 per-(slot, head) scale bytes; a full-width ring "
        "one series at its compute dtype.  The freed difference is "
        "admission headroom the page pool gets back"),

    # -- per-iteration serving ledger (PagedContinuousBatcher.serve_step)
    "serve_step_rows": _g(
        (), "rows processed by the last serving iteration (decode tokens"
        " + prefill chunk rows) against token_budget"),
    "serve_step_host_ms": _g(
        (), "host-side bookkeeping time of the last serving iteration "
        "(overlaps device compute under pipelined decode)"),
    "serve_step_device_ms": _g(
        (), "time the last serving iteration spent BLOCKED on the "
        "device token readback (near zero when pipelining hides it)"),
    "serve_pool_pages_free": _g(
        (), "KV pool pages on the free list (mesh-wide count under "
        "tensor parallelism: tables replicate, a page spans every "
        "shard)"),
    "serve_pool_pages_live": _g(
        (), "KV pool pages privately held by live sequences (mesh-wide "
        "count under tensor parallelism)"),
    "serve_pool_pages_cached": _g(
        (), "KV pool pages resident in the prefix cache (shared or "
        "idle-evictable; mesh-wide count under tensor parallelism)"),

    # -- pool bytes and tensor parallelism at width 1
    "serve_pool_kv_bytes": _g(
        ("dtype",), "KV page pool bytes RESTING by storage dtype "
        "(mesh-wide aggregate, like the page counts; per-device is "
        "serve_tp_pool_bytes_per_device).  A quantized pool reports "
        "two series — int8 page bytes and float32 scale bytes; a "
        "full-width pool one series at its compute dtype.  The gauge "
        "the int8 capacity claim (2x rows per byte budget) is audited "
        "against"),
    "serve_tp_devices": _g(
        (), "tensor-parallel width of the serving mesh (1 = unsharded)"),
    "serve_tp_pool_bytes_per_device": _g(
        (), "KV pool bytes RESTING per device (the aggregate pool "
        "divided by the tensor-parallel width — heads shard 1/tp of "
        "every page)"),
}
