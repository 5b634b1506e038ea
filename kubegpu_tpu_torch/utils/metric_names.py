"""The catalog of every metric name the port emits: its own copy of the
entries of the JAX package's ``utils/metric_names.py`` for the names the
port emits (its gateway, session store and prefix tier, its replica
serving path and its scheduler extender), with the same kind, label keys
and help text, so dashboards read a torch gateway, replica or extender
exactly as a JAX one.

``tests/test_torch_observability.py`` greps ``kubegpu_tpu_torch/`` for
``inc(``/``observe(``/``set_gauge(``/``timer(`` string literals and
fails on a name missing here, on a catalog entry no code emits, and on
an entry that differs from the reference's.  The names of slices still
to come (the int8 pool's quality gauges) arrive with those slices.
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
    # -- scheduler / control plane (scheduler/core.py, utils/apiserver.py)
    "kubegpu_filter_total": _c((), "extender Filter calls"),
    "kubegpu_filter_seconds": _h((), "Filter handler wall time"),
    "kubegpu_prioritize_total": _c((), "extender Prioritize calls"),
    "kubegpu_prioritize_seconds": _h((), "Prioritize handler wall time"),
    "kubegpu_bind_total": _c((), "extender Bind calls"),
    "kubegpu_bind_seconds": _h((), "Bind handler wall time"),
    "kubegpu_bind_conflicts_total": _c(
        (), "binds refused by optimistic-concurrency conflicts"),
    "kubegpu_chips_allocated_total": _c((), "chips handed to pods"),
    "kubegpu_grouped_allocated_total": _c(
        (), "chips allocated via gang (grouped) admission"),
    "kubegpu_placements_total": _c((), "successful placements"),
    "kubegpu_placements_contiguous_total": _c(
        (), "placements that were ICI-contiguous"),
    "kubegpu_preemptions_total": _c((), "preemption plans executed"),
    "kubegpu_preempted_pods_total": _c((), "pods evicted by preemption"),
    "kubegpu_stranded_gang_rollbacks_total": _c(
        (), "partially-bound gangs rolled back after the grace window"),
    "kubegpu_health_evictions_total": _c(
        (), "assignments evicted because their chips disappeared"),

    # -- gateway control plane (gateway/core.py, failover.py, router.py)
    "gateway_requests_total": _c(
        ("outcome",), "terminal results by outcome (ok/rejected/error/"
        "timeout)"),
    "gateway_queue_depth": _g((), "admission queue depth"),
    "gateway_queue_wait_seconds": _h(
        (), "enqueue -> dispatcher pickup wait"),
    "gateway_ttft_seconds": _h(
        ("role",), "enqueue -> full response (unary data plane: TTFT == "
        "TTLT).  Emitted twice per ok request: unlabeled aggregate (the "
        "FleetObserver's window diffs) plus role=colocated|disaggregated "
        "(disaggregated = prefilled on one replica, decoded on another "
        "after the post-prefill handoff)"),
    "gateway_itl_seconds": _h(
        ("role",), "mean inter-token latency per ok request (total / "
        "tokens).  Unlabeled aggregate plus role=colocated|disaggregated "
        "— the pair the disaggregation bench gates on (decode iterations "
        "no longer stalled behind long prefills)"),
    "gateway_phase_handoff_total": _c(
        ("outcome",), "post-prefill KV handoffs by outcome (ok = decode "
        "replica took the sequence; fallback = decode side refused/died "
        "and the prefill replica resumed decode locally; failed = "
        "neither leg landed, normal failover re-dispatched cold)"),
    "gateway_phase_handoff_seconds": _h(
        (), "sealed announcement -> handoff dispatched (export + "
        "re-home + import kickoff wall time)"),
    "gateway_phase_handoff_overlap_seconds": _h(
        (), "per streamed handoff: delta-shipping wall time that ran "
        "DURING prefill compute instead of on the critical path (large "
        "overlap vs gateway_phase_handoff_seconds = handoff-bound TTFT "
        "pressure; the ratio actuator reads the difference)"),
    "gateway_phase_handoff_deltas_total": _c(
        (), "sealed-page deltas acked by the decode side mid-prefill "
        "(the seal-watch pipeline; 0 under stream_handoff=False)"),
    "gateway_phase_handoff_wire_bytes_total": _c(
        ("mode",), "serialized KV payload bytes shipped by post-prefill "
        "handoffs, mode=streamed|oneshot (streamed = final cursor "
        "export after >=1 acked delta; int8 pools halve this per page "
        "vs bf16)"),
    "gateway_live_replicas": _g((), "replicas routable right now"),
    "gateway_deadline_exceeded_total": _c(
        (), "requests failed by the end-to-end deadline"),
    "gateway_failures_total": _c(
        (), "requests failed after exhausting attempts"),
    "gateway_retries_total": _c((), "re-dispatches after a failed attempt"),
    "gateway_retry_budget_exhausted_total": _c(
        (), "retries refused by the retry budget"),
    "gateway_hedges_total": _c((), "hedged (duplicate) dispatches issued"),
    "gateway_hedge_wasted_total": _c(
        (), "hedge attempts cancelled because another attempt won"),
    "gateway_duplicate_results_total": _c(
        (), "second terminal results dropped by exactly-once delivery"),
    "gateway_session_repin_total": _c(
        (), "session re-pins after the pinned replica drained (KV loss "
        "unless a sealed-export restore made the move a transfer — see "
        "gateway_session_restores_total)"),
    "gateway_session_restores_total": _c(
        (), "sealed-chain KV restores imported into a re-pin target "
        "before dispatch (the turn-2 state survived the replica)"),
    "gateway_migrations_total": _c(
        ("outcome",), "live KV-page migrations by outcome (ok = handoff "
        "dispatched; export_failed = source refused/unreachable; "
        "import_refused = target refused the payload)"),
    "gateway_replica_drains_total": _c(
        (), "graceful replica drains started (DRAINING -> released "
        "lifecycles)"),
    "gateway_shed_total": _c(
        ("reason",), "requests shed with an explicit retryable "
        "backpressure result instead of being served (brownout = the "
        "overload ladder's level-3 admission shed of lowest-priority/"
        "over-quota tenants; deadline_expired = shed-before-work, a "
        "request whose deadline lapsed while queued was never "
        "dispatched to burn prefill)"),
    "gateway_brownout_level": _g(
        (), "overload brownout ladder rung in force (0 none; 1 hedging "
        "disabled; 2 + speculation shrunk; 3 + tenant shedding) — set "
        "by the fleet controller when capacity cannot arrive in time"),

    # -- session-KV store, gateway side (gateway/sessionstore.py):
    #    degradation accounting for the external insurance store
    "gateway_session_store_degraded_total": _c(
        ("reason",), "sessions degraded to cold prefill by store "
        "trouble, by reason (unreachable = store down/breaker open; "
        "cas_conflict = a capture lost its versioned put race; "
        "lease_expired = the session's store lease lapsed).  Never a "
        "request error — degradation IS the contract"),
    "gateway_session_store_retries_total": _c(
        (), "store op retries after a transport failure (bounded, "
        "exponential backoff + jitter)"),
    "gateway_session_store_fastfail_total": _c(
        (), "store ops fast-failed by the open circuit breaker (a dead "
        "store costs microseconds per op, not a deadline)"),
    "gateway_session_store_capture_drops_total": _c(
        (), "queued sealed-KV captures dropped oldest-first by the "
        "bounded async write-through queue (capture is insurance, "
        "never admission-blocking)"),

    # -- session-KV store, server side (gateway/sessionstore.py
    #    StoreServer — the standalone store pod's own /metrics)
    "session_store_requests_total": _c(
        ("verb",), "store requests by verb (get/put/list/mark/delete)"),
    "session_store_cas_conflicts_total": _c(
        (), "versioned puts refused because the session's version "
        "moved (a stale capture losing to a newer seal — the two-"
        "gateway race the CAS exists for)"),
    "session_store_lease_expired_total": _c(
        (), "sessions dropped because their lease lapsed (reads after "
        "expiry answer 404 reason=lease_expired; the gateway degrades "
        "to cold prefill)"),
    "session_store_payloads_dropped_total": _c(
        (), "sealed-KV payloads evicted oldest-first by the byte-"
        "bounded LRU (streams stay; those sessions restore cold)"),
    "session_store_sessions": _g((), "session entries resident"),
    "session_store_payload_bytes": _g(
        (), "total retained sealed-KV payload bytes (bounded by "
        "--max-payload-bytes, default 256 MiB)"),
    "session_store_payload_dedup_total": _c(
        (), "sealed-KV payload writes answered by an existing content-"
        "addressed record instead of a second copy (a payload captured "
        "by N sessions and published as a prefix rests ONCE; refcounts "
        "track the sharers)"),
    "session_store_prefixes": _g(
        (), "fleet prefix chains resident in the store's prefix "
        "namespace"),
    "session_store_prefix_evicted_total": _c(
        (), "prefix chains evicted by the popularity-weighted LRU "
        "(fewest probe hits first, oldest touch breaking ties) or "
        "reaped by the idle lease — prefixes are immortal only while "
        "hot, never leased like sessions"),
    "prefix_tier_resident_bytes": _g(
        (), "payload bytes the prefix namespace keeps resident (its "
        "share of the content-addressed payload table; bounded by "
        "--max-prefix-bytes)"),

    # -- fleet-wide shared-prefix KV tier (gateway/prefixtier.py,
    #    router.py): prefill any hot prefix once, ever
    "gateway_prefix_tier_hits_total": _c(
        (), "admission-time tier probes that found a stored chain "
        "sharing at least one full page with the prompt (the payload "
        "then imports into the target replica before prefill)"),
    "gateway_prefix_tier_misses_total": _c(
        (), "tier probes that found no stored prefix (cold prefill as "
        "usual; the completion's publish may seed the tier for the "
        "next caller)"),
    "gateway_prefix_tier_publishes_total": _c(
        (), "sealed chains published into the tier's prefix namespace "
        "(post-dedup: the gateway's published-set and the store's "
        "metadata-first probe both gate re-uploads)"),
    "gateway_prefix_tier_imports_total": _c(
        (), "tier payloads imported into a replica's PrefixPageCache "
        "before prefill (the fleet-warm pages the admission then hits)"),
    "gateway_prefix_tier_degraded_total": _c(
        ("reason",), "tier ops resolved as counted cold prefill by "
        "store trouble, by reason (unreachable = store down/breaker "
        "open; error = malformed or refused op).  Never a request "
        "error — the session-store degradation contract, applied to "
        "prefixes"),
    "gateway_prefix_tier_publish_drops_total": _c(
        (), "queued publishes dropped oldest-first by the bounded "
        "async publish queue (publishing is opportunistic seeding, "
        "never result-path-blocking)"),
    "gateway_prefix_route_warm_total": _c(
        (), "requests the PrefixLocalityRouter routed by longest "
        "locally-warm prefix instead of the consistent-hash ring "
        "fallback (agent fleets packing onto warm replicas)"),

    # -- gateway streaming pass-through (gateway/server.py, failover.py)
    "gateway_stream_requests_total": _c(
        (), "streaming (SSE) /v1/generate requests accepted"),
    "gateway_stream_tokens_total": _c(
        (), "tokens relayed to streaming callers as they came off "
        "replicas (the terminal result stays authoritative)"),
    "gateway_stream_disconnects_total": _c(
        (), "streaming callers that vanished mid-stream; each one "
        "cancelled its in-flight attempts wire-level (replica pages "
        "freed)"),
    "gateway_stream_hedges_total": _c(
        (), "hedged dispatches issued for STREAMING requests — safe "
        "because the StreamRelay dedups twin streams by token index; "
        "greedy and seed-pinned sampled streams hedge, unpinned "
        "sampled streams never do"),
    "gateway_sampled_hedges_total": _c(
        (), "hedged dispatches issued for SAMPLED (temperature > 0) "
        "requests — possible only because the request pinned a seed, "
        "making every replica's sampled stream byte-identical"),
    "gateway_stream_dedup_tokens_total": _c(
        (), "tokens a streaming attempt delivered that the caller "
        "already had (hedge twin / retry overlap) — dropped by the "
        "relay's dedup watermark, never surfaced twice"),

    # -- gateway tier (gateway/tier.py): the N-gateway scale-out layer
    "gateway_tier_gateways": _g(
        (), "gateways alive in this tier right now"),
    "gateway_tier_deaths_total": _c(
        (), "gateway instances killed (chaos or crash); their in-flight "
        "attempts cancel wire-level and their pendings fail with the "
        "retryable 'gateway died' error"),
    "gateway_tier_retries_total": _c(
        (), "tier-client retries of a request on a sibling gateway "
        "after its home gateway died (same request_id; replica-side "
        "duplicate-id eviction keeps at most one live stream)"),


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

    # -- pool bytes and tensor-parallel serving (models/paging.py with a
    #    mesh): the per-device half of the pool economy plus the
    #    collective traffic the Megatron all-reduces cost per iteration
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
    "serve_tp_collective_bytes_total": _c(
        (), "modeled per-device all-reduce wire bytes of the serving "
        "iterations' TP psums (2 per transformer block: o_proj + "
        "mlp_down; ring cost 2*(tp-1)/tp of the payload; 0 at tp=1)"),
}
