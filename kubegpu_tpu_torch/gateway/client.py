"""The port's copy of the JAX package's ``gateway/client.py``.

ReplicaClient: the gateway's only data-plane dependency.

Mirrors the ApiServer pattern (SURVEY.md §4: every cluster dependency
behind an interface with an in-memory fake): the gateway dispatches
decode work through this interface and never opens a socket itself.

``InMemoryReplicaClient`` is the fake — one worker thread per replica
driving a batcher through the incremental serving API
(``submit``/``serve_step``/``cancel``), so e2e tests exercise the REAL
queue → route → admit → decode → retire path.  The batcher is duck-typed:
a real ``models.serving.ContinuousBatcher`` (true JAX decode, the e2e
wiring the tentpole demands) or a ``SimBatcher`` (pure-python token
mill) both fit — the soak and the 200-request acceptance test use the
latter so chaos runs stay fast and deterministic.

Failure model: ``fail_replica`` is the pod's process dying with its
chips — every in-flight attempt errors (the moral equivalent of a
connection reset), new submissions are refused.  ``sync_live`` wires
that to the registry's live-set subscription, so a chip death observed
by the control plane kills the data-plane connection the same cycle.
"""

from __future__ import annotations

import inspect
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional

# the paged batchers' session-KV-reuse policy values and KV page-pool
# storage formats.  Canonically declared in models/serving.py
# (DECODE_PAGE_CACHE_POLICIES / KV_DTYPES); mirrored here because the
# gateway layer is deliberately jax-free and must not import the model
# stack for a few string tuples.  The pairs are pinned equal by
# tests/test_multiturn_kv.py and tests/test_quantized_pool.py.
DECODE_PAGE_CACHE_POLICIES = ("off", "fp32", "quantized", "all")
KV_DTYPES = ("bf16", "fp32", "int8")


def _sniff_takes(batcher, method: str, param: str) -> bool:
    """Does this batcher's ``method`` accept keyword ``param``?
    Duck-typed once per worker/serving-loop so third-party batchers
    without the kwarg still work.  Shared with the HTTP data plane
    (gateway/dataplane.py) so both drivers sniff identically."""
    try:
        fn = getattr(batcher, method)
        return param in inspect.signature(fn).parameters
    except (AttributeError, TypeError, ValueError):
        return False


def _sniff_takes_trace(batcher, method: str = "submit") -> bool:
    """Trace-context contract sniff (on ``submit`` or, for migration,
    ``import_pages``): requests on batchers without the kwarg simply
    serve untraced below the dispatch span."""
    return _sniff_takes(batcher, method, "trace")


def _payload_nbytes(payload: dict) -> int:
    """Approximate transfer size of a KV payload over the in-memory
    plane (no wire): the page/scale array bytes plus a nominal cursor
    overhead — the handoff wire-bytes metric's in-process stand-in,
    same order as the HTTP codec's encoded body."""
    total = 256   # cursor fields (tokens, keys, geometry) — nominal
    for sect in ("layers", "scales"):
        for k_arr, v_arr in payload.get(sect) or []:
            total += int(getattr(k_arr, "nbytes", 0) or 0)
            total += int(getattr(v_arr, "nbytes", 0) or 0)
    total += 4 * len(payload.get("tokens") or [])
    return total


def sim_stream_seed(prompt) -> int:
    """Request-deterministic stream seed for the SimBatcher mill.

    Real replicas serving the same weights emit the SAME greedy stream
    for the same prompt — the property hedged streaming's prefix dedup,
    sibling-gateway retries and mid-stream migrations all lean on.  The
    data planes model it by seeding the mill from the PROMPT (position-
    weighted so permutations differ) instead of the replica-local slot
    id: any replica, any resubmission, any continuation of the same
    request mills the same tokens.  Direct SimBatcher use without a
    ``stream_seed`` keeps the historical per-seq streams."""
    toks = [int(t) for t in prompt]
    return (
        len(toks) * 131
        + sum(t * (i + 1) for i, t in enumerate(toks))
    ) % 1000003


@dataclass
class AttemptResult:
    ok: bool
    tokens: List[int] = field(default_factory=list)
    error: str = ""


class Attempt:
    """Handle for one dispatch of one request to one replica.  Resolves
    exactly once; ``finish`` after the first call is a no-op (a cancelled
    attempt racing its own completion must not flap the result)."""

    def __init__(self, replica: str, request_id: str) -> None:
        self.replica = replica
        self.request_id = request_id
        self.cancelled = False
        # the request this attempt carries (stashed by the clients at
        # submit): live migration re-dispatches the SAME attempt handle
        # against a new replica, which needs the original request
        self.request = None
        # set while a live migration owns this attempt's resolution: the
        # exporter's stream ends with a "migrated" terminal the reader
        # must NOT surface as a failure
        self._migrating = False
        # set by the reader when it SEES that terminal — the handshake
        # migrate()'s export-failure path uses to resolve an attempt
        # whose sequence detached but whose export response was lost
        self._migrated_terminal = False
        # absolute token index this attempt's FIRST streamed delta
        # starts at: 0 normally; a hedge/retry fast-forwarded by a
        # resume watermark starts past the caller's delivered prefix
        # (set by the data-plane client that applied the watermark —
        # the StreamRelay indexes deltas with it)
        self.stream_base = 0
        # prefill/decode disaggregation: set by the replica when the
        # prompt's pages SEAL with zero tokens emitted (a prefill-only
        # batcher parked the sequence) — the dispatcher reacts by
        # handing the sequence off to a decode replica over the
        # migration verbs.  Sealed ⇒ parked ⇒ a handoff is REQUIRED:
        # the sequence decodes nowhere until one lands (or falls back)
        self.sealed = threading.Event()
        # where the handoff ended up: "" (none yet) | "ok" (decode
        # replica took it) | "fallback" (decode side refused/died;
        # the sequence resumed ON the prefill replica)
        self.handoff_outcome = ""
        self.handoff_wire_bytes = 0
        self._done = threading.Event()
        self._result: Optional[AttemptResult] = None
        self._lock = threading.Lock()

    def finish(self, result: AttemptResult) -> bool:
        with self._lock:
            if self._result is not None:
                return False
            self._result = result
        self._done.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self) -> Optional[AttemptResult]:
        return self._result


class ReplicaClient:
    def submit(self, replica_key: str, request) -> Attempt:
        """Dispatch one request; never blocks on decode (returns a handle).
        An unreachable replica resolves the handle immediately with an
        error — connection refusal is a RESULT, not an exception."""
        raise NotImplementedError

    def cancel(self, attempt: Attempt) -> None:
        """Best-effort: stop decoding the attempt's request (hedge loser,
        expired deadline).  The attempt resolves with an error if it had
        not already finished."""
        raise NotImplementedError

    def ready(self) -> bool:
        """Can this client plausibly reach replicas at all?  /readyz ANDs
        this with replica discovery — a gateway whose data plane is a
        dead end must never join a Service, however many replicas the
        registry sees."""
        return True

    # -- KV-page migration (optional capability) ---------------------------
    # Data planes that speak the EXPORT/IMPORT verb pair override these;
    # the defaults say "unsupported" so drains degrade to the pre-verb
    # behavior (cold restarts) instead of erroring.

    def inflight_on(self, replica_key: str) -> List[Attempt]:
        """Live attempts currently dispatched to one replica — the drain
        path's work list."""
        return []

    def migrate(self, attempt: Attempt, request, to_key: str,
                _between: Optional[Callable[[], None]] = None,
                fallback: bool = False, cursor: int = 0) -> bool:
        """Move a live in-flight sequence to another replica: export +
        detach at the source, import + resume at the target; the SAME
        attempt handle keeps streaming and eventually resolves with the
        full token list.  False = migration not possible (the sequence
        stays where it was, or normal failover takes over).  ``_between``
        is a fault-injection hook invoked between the export and the
        import dispatch (the soak's kill-mid-migration schedules).
        ``fallback`` (the post-prefill handoff contract): an import
        refusal/death re-imports the held payload into the SOURCE and
        resumes decode there instead of erroring the attempt.
        ``cursor`` (the streamed handoff): the first ``cursor`` pages
        already shipped as acked deltas, so the final export carries
        keys for every page but bytes only from ``cursor`` on."""
        return False

    # -- streamed seal-time handoff (optional capability) ------------------
    # Data planes that can ship sealed pages DURING prefill override
    # these; the defaults say "unsupported", which degrades a handoff
    # to the one-shot post-seal transfer.

    def export_delta(self, attempt: Attempt, request,
                     cursor: int) -> Optional[dict]:
        """Pages of the attempt's sequence sealed since page index
        ``cursor`` (chain keys included), or None (nothing new sealed,
        sequence not streamable right now, or unsupported)."""
        return None

    def import_delta(self, replica_key: str, payload) -> Optional[int]:
        """Stage a streamed-handoff delta on a replica's prefix cache.
        Returns the staged-page count (an ACK — the exporter may
        reclaim through the delta's pages), or None when refused or
        unsupported (the dispatcher falls back to one-shot)."""
        return None

    def reclaim(self, attempt: Attempt, request, upto: int) -> int:
        """Release the attempt's first ``upto`` pages on its (parked)
        prefill replica — they were acked by the importer.  Returns
        pages freed; 0 = nothing to do or unsupported (best-effort)."""
        return 0

    def export_sealed(self, replica_key: str, stream) -> Optional[dict]:
        """Capture a finished stream's sealed prefix-chain pages from a
        replica (the failover insurance payload), or None."""
        return None

    def import_sealed(self, replica_key: str, payload) -> bool:
        """Warm a replica's prefix cache from a sealed-chain export."""
        return False

    def seals_decode(self, replica_key: str) -> bool:
        """Does this replica seal decode pages at retirement?  Gates the
        gateway's eager sealed-export captures (no point round-tripping
        a replica whose policy never seals)."""
        return False

    def set_speculation(self, cap: Optional[int]) -> int:
        """Brownout rung 2: cap (or restore, ``None``) speculative
        decode fleet-wide — the verify window's extra budget rows go
        back to admissions under overload.  Returns how many replicas
        actually adjusted; the default says "unsupported" (0), which
        degrades the rung to a no-op rather than an error.  Greedy
        output is lossless for ANY draft, so the cap never changes
        tokens — only per-step emission batching."""
        return 0


# ---------------------------------------------------------------------------
# SimBatcher: pure-python stand-in with the ContinuousBatcher serving API
# ---------------------------------------------------------------------------

class SimBatcher:
    """Deterministic token mill with the incremental serving API
    (submit/serve_step/cancel/has_work) but no JAX: token *i* of request
    *seq* is ``(seq * 31 + i) % vocab``, one token per serve_step per
    active sequence, ``slots`` sequences decode concurrently.  Lets soak
    and scale tests drive thousands of requests through the real gateway
    machinery in milliseconds.

    ``token_budget`` models the real batchers' token-budget step cap:
    at most that many sequences advance a token per serve_step, rotated
    round-robin so none starves (None = every active sequence advances,
    the historical behavior).  Per-sequence streams stay deterministic
    either way — token *i* depends only on (seq, i).

    ``speculate_k`` models draft-then-verify speculative decode: an
    advancing sequence emits a deterministic 1..k+1 tokens per step (the
    "accepted prefix" — a function of (seq, depth) only, so streams stay
    byte-identical to the non-speculative mill), and bills k+1 budget
    rows against ``token_budget`` whether or not the tail was accepted —
    exactly the paged scheduler's accounting (a speculative slot's
    verify window is k+1 rows wide regardless of acceptance).

    ``decode_page_cache`` is the paged batchers' session-KV-reuse policy
    ({"off", "fp32", "quantized", "all"}): the mill has no KV to seal,
    so it only validates the widened contract — a policy typo must die
    at replica construction here exactly as it would on a real batcher.

    ``kv_dtype`` is the paged batchers' page-pool storage format
    ({None, "bf16", "fp32", "int8"}): the mill stores no KV, so it
    validates the contract, advertises the format, and stamps it into
    its migration payloads — an importer on a different format refuses
    exactly like a real batcher's geometry check.

    ``submit(..., trace=)`` takes the caller's span context like the
    real batchers and emits the same minimal subtree (serve → queue →
    decode → retire), so gateway-level trace oracles (soak I5 from
    spans) run against the millisecond-fast mill too."""

    def __init__(self, slots: int = 8, vocab: int = 256,
                 token_budget: Optional[int] = None,
                 speculate_k: Optional[int] = None,
                 decode_page_cache: str = "off",
                 kv_dtype: Optional[str] = None,
                 tp: int = 1, prefill_only: bool = False) -> None:
        if token_budget is not None and token_budget <= 0:
            raise ValueError(
                f"token_budget ({token_budget}) must be positive or None"
            )
        if speculate_k is not None and speculate_k < 1:
            raise ValueError(
                f"speculate_k ({speculate_k}) must be >= 1 or None"
            )
        if decode_page_cache not in DECODE_PAGE_CACHE_POLICIES:
            raise ValueError(
                f"decode_page_cache must be one of "
                f"{DECODE_PAGE_CACHE_POLICIES}, got {decode_page_cache!r}"
            )
        if kv_dtype is not None and kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES} or None, got "
                f"{kv_dtype!r}"
            )
        if tp < 1:
            # the paged batchers' tensor-parallel width contract: the
            # mill has no mesh, so it only validates and ADVERTISES the
            # width (the /state replica_mesh surface) — a bad
            # value must die at replica construction here exactly as a
            # real batcher's mesh validation would
            raise ValueError(f"tp ({tp}) must be >= 1")
        self.slots = slots
        self.vocab = vocab
        self.token_budget = token_budget
        self.speculate_k = speculate_k
        # the CONFIGURED width; set_speculation_cap clamps/restores the
        # live speculate_k against it (brownout rung 2).  Token VALUES
        # are a function of (seed, index) only, so capping speculation
        # never changes a stream — just how many tokens a step emits.
        self._spec_configured = speculate_k
        self.decode_page_cache = decode_page_cache
        # canonical storage name for /state and migration payloads —
        # the REAL batcher advertises numpy-style names
        # ("bfloat16"/"float32"/"int8"), so the mill maps the CLI knob
        # the same way or a mixed fleet would read as a spurious
        # kv_dtype skew (the mill "computes" nothing; its full-width
        # twin is bf16)
        self.kv_dtype = {
            "bf16": "bfloat16", "fp32": "float32", "int8": "int8",
        }[kv_dtype or "bf16"]
        self.tp = tp
        self._pending: deque = deque()
        self._active: Dict[int, tuple] = {}  # seq -> (tokens, max_new)
        self._rr: deque = deque()            # active seqs in budget order
        self._spans: Dict[int, dict] = {}    # seq -> open span ctxs
        # migration keeps streams deterministic ACROSS replicas: token i
        # is a function of (seed, i), and the seed rides the export
        # payload — an imported sequence continues the ORIGINAL mill's
        # stream even though the importer assigned it a fresh seq id
        self._seed: Dict[int, int] = {}      # seq -> stream seed
        # prefill-only serving mode (disaggregation): the mill's
        # "prefill" is instant, so a fresh admission SEALS immediately
        # and PARKS — it never enters the decode ring until the gateway
        # exports it (drain_sealed surfaces the seq ids) or the mode
        # flips off.  Imported sequences bypass parking: the fallback
        # contract resumes decode HERE when the decode side refuses.
        self.prefill_only = bool(prefill_only)
        self._parked: set = set()            # parked (sealed) seq ids
        self._imported: set = set()          # seqs that arrived via import
        self._sealed_pending: List[int] = [] # sealed-but-unannounced
        # streamed-handoff twins: the mill's "sealed chain" is one sim
        # page per prompt token (no KV — pure cursor bookkeeping, so
        # the dispatcher's seal-watch/delta/ack/reclaim machinery runs
        # against the mill too)
        self._plen: Dict[int, int] = {}      # seq -> prompt length
        self._reclaimed: Dict[int, int] = {} # seq -> reclaim watermark
        self._staged: set = set()            # delta page keys staged here
        self.stats = {"steps": 0, "admits": 0, "imports": 0,
                      "pages_reclaimed": 0}

    def submit(self, seq_id: int, prompt, max_new: int,
               temperature: float = 0.0,
               session_id: Optional[str] = None, trace=None,
               stream_seed: Optional[int] = None,
               seed: Optional[int] = None) -> None:
        # session_id is the gateway's session/prefix key; the token mill
        # has no KV to reuse, so it only validates the widened contract.
        # stream_seed: the data planes pass sim_stream_seed(prompt) so
        # streams are REQUEST-deterministic (identical on any replica,
        # like real greedy decode); None keeps the per-seq mill.
        # seed: the caller's sampling pin — mixed into the mill seed so
        # a pinned sampled request mills the SAME stream on any replica
        # (the real batchers' position-keyed determinism, scaled down)
        # while different seeds mill different streams.
        if seq_id < 0:
            raise ValueError(f"seq_id must be >= 0, got {seq_id}")
        if trace is not None:
            old = self._spans.pop(seq_id, None)
            if old is not None:
                self._trace_end(old, "resubmitted")
            serve = trace.child("serve", seq_id=seq_id, sim=True)
            self._spans[seq_id] = {
                "serve": serve, "queue": serve.child("queue"),
            }
        try:
            self._plen[seq_id] = len(prompt)
        except TypeError:
            self._plen[seq_id] = 0
        mill = seq_id if stream_seed is None else int(stream_seed)
        if seed is not None:
            # Knuth-mix the pin so (prompt, seed) fully determines the
            # stream and seed=0 still perturbs the unpinned stream
            mill = (mill * 31 + int(seed) * 2654435761 + 1) % (2 ** 31)
        self._pending.append((seq_id, int(max_new), mill))

    def _trace_end(self, spans: dict, reason: str, **attrs) -> None:
        serve = spans.pop("serve")
        for span in spans.values():
            span.end()
        serve.event("retire", reason=reason, **attrs)
        serve.end()

    def trace_shutdown(self, reason: str = "replica died") -> None:
        # reason rides as `note` (the retire reason keys the documented
        # finished|cancelled|died enum; the note says WHICH replica)
        for seq in list(self._spans):
            self._trace_end(self._spans.pop(seq), "died", note=reason)

    def cancel(self, seq_id: int) -> bool:
        for i, (sid, *_rest) in enumerate(self._pending):
            if sid == seq_id:
                del self._pending[i]
                self._plen.pop(sid, None)
                if sid in self._spans:
                    self._trace_end(self._spans.pop(sid), "cancelled")
                return True
        if self._active.pop(seq_id, None) is None:
            return False
        # drop the ring entry too: a stale entry would double-count a
        # re-submitted seq_id against the budget forever (a PARKED
        # sequence never entered the ring — the export+detach path
        # cancels exactly these)
        if seq_id in self._parked:
            self._parked.discard(seq_id)
            if seq_id in self._sealed_pending:
                self._sealed_pending.remove(seq_id)
        else:
            self._rr.remove(seq_id)
        self._imported.discard(seq_id)
        self._seed.pop(seq_id, None)
        self._plen.pop(seq_id, None)
        self._reclaimed.pop(seq_id, None)
        if seq_id in self._spans:
            self._trace_end(self._spans.pop(seq_id), "cancelled")
        return True

    # -- KV migration twins (the paged batcher's verb pair, duck-typed):
    # the mill has no pages, so the payload is the stream cursor alone —
    # which is exactly what keeps soak streams deterministic across a
    # migration (token i depends only on (seed, i))
    def export_pages(self, seq_id: int, cursor: int = 0) -> dict:
        ent = self._active.get(seq_id)
        if ent is None:
            raise KeyError(f"sequence {seq_id} not active")
        tokens, max_new = ent
        # cursor (streamed handoff): the mill ships no bytes, so the
        # final export just records the offset — importers ignore it
        return {
            "kind": "live", "sim": True, "tokens": list(tokens),
            "max_new": int(max_new),
            "seed": int(self._seed.get(seq_id, seq_id)),
            "kv_dtype": self.kv_dtype, "layer_base": int(cursor),
        }

    def import_pages(self, seq_id: int, payload: dict,
                     trace=None) -> None:
        if payload.get("kind") != "live" or not payload.get("sim"):
            raise ValueError("not a sim-mill payload")
        if payload.get("kv_dtype", "bfloat16") != self.kv_dtype:
            # the real batchers' geometry refusal, mill-modeled: pages
            # stored in one format are not importable into another
            raise ValueError(
                f"transfer geometry mismatch on kv_dtype: payload "
                f"{payload.get('kv_dtype')!r} vs this batcher "
                f"{self.kv_dtype!r}"
            )
        if seq_id in self._active or any(
            sid == seq_id for sid, *_rest in self._pending
        ):
            raise ValueError(f"seq_id {seq_id} already in use")
        if len(self._active) >= self.slots:
            raise RuntimeError("import refused: no free slot")
        self._active[seq_id] = (
            list(payload["tokens"]), int(payload["max_new"])
        )
        self._seed[seq_id] = int(payload["seed"])
        # imported sequences DECODE even in prefill-only mode: the
        # handoff-fallback contract resumes a refused sequence on the
        # prefill replica that exported it
        self._imported.add(seq_id)
        self._rr.append(seq_id)
        self.stats["imports"] += 1
        if trace is not None:
            serve = trace.child("serve", seq_id=seq_id, sim=True,
                                imported=True)
            self._spans[seq_id] = {
                "serve": serve, "decode": serve.child("decode"),
            }

    def set_speculation_cap(self, cap: Optional[int]) -> bool:
        """Live speculation cap (brownout rung 2): ``None`` restores
        the configured width, 0 disables speculation, k clamps to
        min(configured, k).  Returns whether anything changed."""
        if self._spec_configured is None:
            return False
        if cap is None:
            new = self._spec_configured
        elif cap <= 0:
            new = None
        else:
            new = min(self._spec_configured, int(cap))
        changed = new != self.speculate_k
        self.speculate_k = new
        return changed

    # -- disaggregation verbs (duck-typed; the paged batcher's twins) ------
    def drain_sealed(self) -> List[int]:
        """Seq ids whose prompts sealed with zero tokens emitted since
        the last drain — the serving loop announces each one upstream
        exactly once (the dispatcher's handoff trigger)."""
        out, self._sealed_pending = self._sealed_pending, []
        return out

    def set_prefill_only(self, flag: bool) -> bool:
        """Flip the serving mode live (the controller's role actuator).
        Disabling UNPARKS every sealed sequence into the decode ring —
        collapse-to-colocated must never strand a parked stream.
        Mirror of the paged contract: a sequence whose handoff stream
        already RECLAIMED pages stays parked (its handoff completes or
        falls back through the import path instead)."""
        flag = bool(flag)
        changed = flag != self.prefill_only
        self.prefill_only = flag
        if not flag:
            keep = {s for s in self._parked if self._reclaimed.get(s)}
            for seq in sorted(self._parked - keep):
                if seq in self._active:
                    self._rr.append(seq)
            self._parked = keep
            self._sealed_pending = []
        return changed

    # -- streamed seal-time handoff twins ----------------------------------
    def export_sealed_delta(self, seq_id: int,
                            cursor: int) -> Optional[dict]:
        """The paged batcher's streaming export, mill-modeled: the sim
        chain is one page per prompt token (sealed in full the moment
        the sequence parks — the mill's prefill is instant), each page
        keyed by (stream seed, index) so staging dedups exactly like
        content addressing."""
        if seq_id not in self._active:
            raise KeyError(f"sequence {seq_id} not active")
        if seq_id not in self._parked:
            raise ValueError(f"sequence {seq_id} is decoding")
        n = self._plen.get(seq_id, 0)
        cursor = int(cursor)
        if cursor < 0 or cursor > n:
            raise ValueError(
                f"delta cursor {cursor} outside sealed bound {n}"
            )
        if cursor < self._reclaimed.get(seq_id, 0):
            raise ValueError(
                f"delta cursor {cursor} below reclaim watermark "
                f"{self._reclaimed[seq_id]}"
            )
        if cursor == n:
            return None
        seed = self._seed.get(seq_id, seq_id)
        return {
            "kind": "delta", "sim": True, "cursor": cursor,
            "page_keys": [f"{seed:x}:{j:x}" for j in range(cursor, n)],
            "sealed": True, "kv_dtype": self.kv_dtype,
        }

    def import_sealed_delta(self, payload: dict) -> int:
        """Stage a delta's sim pages (dedup by key, like the paged
        cache); the count returned is the exporter's ACK."""
        if payload.get("kind") != "delta" or not payload.get("sim"):
            raise ValueError("not a sim-mill delta payload")
        if payload.get("kv_dtype", "bfloat16") != self.kv_dtype:
            raise ValueError(
                f"transfer geometry mismatch on kv_dtype: payload "
                f"{payload.get('kv_dtype')!r} vs this batcher "
                f"{self.kv_dtype!r}"
            )
        fresh = [
            k for k in payload.get("page_keys") or []
            if k not in self._staged
        ]
        self._staged.update(fresh)
        return len(fresh)

    def reclaim_handoff_pages(self, seq_id: int, upto: int) -> int:
        """Advance a parked sequence's reclaim watermark (the mill has
        no pool — the counter IS the contract under test)."""
        if seq_id not in self._active:
            raise KeyError(f"sequence {seq_id} not active")
        if seq_id not in self._parked:
            return 0
        upto = min(int(upto), self._plen.get(seq_id, 0))
        freed = max(0, upto - self._reclaimed.get(seq_id, 0))
        if freed:
            self._reclaimed[seq_id] = upto
            self.stats["pages_reclaimed"] += freed
        return freed

    def assert_page_accounting(self) -> None:
        """The mill's invariant twin of the paged batcher's check —
        what the soak's both-ends oracle holds a sim replica to:
        every active sequence sits in exactly one of the decode ring
        or the parked set, every pending seal announcement names a
        parked sequence, and reclaim watermarks only ever cover a
        parked sequence's sealed sim chain."""
        ring = set(self._rr)
        for seq in self._active:
            parked = seq in self._parked
            assert parked != (seq in ring), (
                f"seq {seq}: parked={parked}, in_ring={seq in ring}"
            )
        for seq in self._sealed_pending:
            assert seq in self._parked, (
                f"seal announced for unparked seq {seq}"
            )
        for seq, upto in self._reclaimed.items():
            assert seq in self._parked, (
                f"reclaim watermark on unparked seq {seq}"
            )
            assert upto <= self._plen.get(seq, 0), (
                f"seq {seq} reclaimed {upto} past its chain"
            )

    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._active)

    def live_tokens(self) -> Dict[int, List[int]]:
        """Committed tokens of every ACTIVE sequence (the real batchers'
        incremental-streaming surface): the HTTP serving loop reads this
        after each serve_step to emit one SSE event per committed token
        batch."""
        return {seq: list(t) for seq, (t, _) in self._active.items()}

    def serve_step(self) -> Dict[int, List[int]]:
        finished: Dict[int, List[int]] = {}
        while self._pending and len(self._active) < self.slots:
            seq, max_new, seed = self._pending.popleft()
            self.stats["admits"] += 1
            spans = self._spans.get(seq)
            if spans is not None and "queue" in spans:
                spans.pop("queue").end()
                if max_new > 0:
                    spans["decode"] = spans["serve"].child("decode")
            if max_new <= 0:
                if spans is not None:
                    self._trace_end(self._spans.pop(seq), "finished")
                self._plen.pop(seq, None)
                finished[seq] = []
            else:
                # a re-submitted still-active seq restarts its stream but
                # must NOT gain a second ring entry (double budget draw)
                park = self.prefill_only and seq not in self._imported
                in_ring = seq in self._active and seq not in self._parked
                if park and in_ring:
                    self._rr.remove(seq)
                elif not park and not in_ring:
                    self._rr.append(seq)
                if park:
                    # prefill-only: the mill's prefill is instant, so
                    # the prompt seals AT admission and the sequence
                    # parks awaiting its handoff export
                    self._parked.add(seq)
                    if seq not in self._sealed_pending:
                        self._sealed_pending.append(seq)
                else:
                    self._parked.discard(seq)
                self._active[seq] = ([], max_new)
                self._seed[seq] = seed
        if self._active:
            self.stats["steps"] += 1
            # parked sequences run ZERO decode steps: counting them
            # against the token budget would starve the ring of rows
            # they never use (the real batcher's admission budget
            # excludes parked slots the same way)
            n = sum(1 for s in self._active if s not in self._parked)
            if self.token_budget is not None:
                # a speculative sequence bills its whole k+1-row verify
                # window; at least one sequence always advances (the
                # real batchers' can't-starve floor)
                rows = (self.speculate_k or 0) + 1
                n = min(n, max(1, self.token_budget // rows))
            advanced = 0
            for _ in range(len(self._rr)):
                if advanced >= n:
                    break
                seq = self._rr.popleft()
                if seq not in self._active:
                    continue  # cancelled: drop its stale ring entry
                advanced += 1
                tokens, max_new = self._active[seq]
                seed = self._seed.get(seq, seq)
                if self.speculate_k is None:
                    emit = 1
                else:
                    # deterministic accepted-prefix length in [1, k+1],
                    # a function of (seed, depth) only: re-running the
                    # same request — or resuming it on another replica
                    # after a migration — yields the same emissions
                    emit = 1 + (seed * 7 + len(tokens)) % (
                        self.speculate_k + 1
                    )
                for _ in range(min(emit, max_new - len(tokens))):
                    tokens.append((seed * 31 + len(tokens)) % self.vocab)
                if len(tokens) >= max_new:
                    finished[seq] = tokens
                    del self._active[seq]
                    self._seed.pop(seq, None)
                    self._plen.pop(seq, None)
                    self._reclaimed.pop(seq, None)
                    if seq in self._spans:
                        self._trace_end(self._spans.pop(seq), "finished")
                else:
                    self._rr.append(seq)
        return finished


# ---------------------------------------------------------------------------
# InMemoryReplicaClient: per-replica worker threads over duck-typed batchers
# ---------------------------------------------------------------------------

class _ReplicaWorker:
    def __init__(self, key: str, batcher, step_delay_s: float) -> None:
        self.key = key
        self.batcher = batcher
        self.step_delay_s = step_delay_s
        self._takes_trace = _sniff_takes_trace(batcher)
        self._takes_stream_seed = _sniff_takes(
            batcher, "submit", "stream_seed"
        )
        self._takes_seed = _sniff_takes(batcher, "submit", "seed")
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.inbox: deque = deque()          # (attempt, request)
        self.cancels: List[Attempt] = []
        # control ops (export/import, sealed captures): closures run ON
        # the worker thread between steps — the batchers are
        # single-driver, and migration must never race serve_step
        self.ops: deque = deque()            # (fn, reply queue)
        # chaos knob: an armed worker refuses imports (the soak's
        # importer-refusal schedule; the HTTP twin is the worker CLI's
        # --serve-http-fail-migration)
        self.fail_migration = False
        self.alive = True
        self.by_seq: Dict[int, Attempt] = {}
        # streaming parity with the HTTP data plane: per-sequence token
        # sink + emitted watermark, fed from the batcher's live_tokens()
        # after each step so `on_tokens` callers see committed batches
        # from the in-memory plane too
        self.sinks: Dict[int, Callable] = {}
        self.emitted: Dict[int, int] = {}
        self._next_seq = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            with self.cond:
                while (self.alive and not self.inbox and not self.cancels
                       and not self.ops and not self.batcher.has_work()):
                    self.cond.wait(0.05)
                if not self.alive:
                    dead = list(self.by_seq.values())
                    dead += [a for a, _ in self.inbox]
                    self.by_seq.clear()
                    self.inbox.clear()
                    # blocked control callers must not hang on a corpse
                    while self.ops:
                        _, reply = self.ops.popleft()
                        reply.put((False, RuntimeError(
                            f"replica {self.key} died"
                        )))
                    # the process dies with its spans: close every live
                    # request's subtree (retire reason "died") so the
                    # trace tree stays complete — the in-memory twin of
                    # a pod death ending its connections
                    shutdown = getattr(self.batcher, "trace_shutdown", None)
                    if shutdown is not None:
                        shutdown(f"replica {self.key} died")
                    break
                while self.inbox:
                    attempt, req = self.inbox.popleft()
                    dl = getattr(req, "deadline_s", None)
                    anchor = getattr(req, "enqueued_at", 0.0) or 0.0
                    if dl is not None and anchor and (
                        time.monotonic() >= anchor + dl
                    ):
                        # shed-before-work parity with the wire plane:
                        # a request that aged past its deadline in this
                        # worker's inbox is refused before any decode
                        attempt.finish(AttemptResult(
                            False, error="deadline expired before "
                            "admission (backpressure)",
                        ))
                        continue
                    seq = self._next_seq
                    self._next_seq += 1
                    kwargs = {"session_id": getattr(req, "session", None)}
                    if self._takes_trace:
                        kwargs["trace"] = getattr(req, "trace", None)
                    if self._takes_stream_seed:
                        # request-deterministic mill streams: any replica
                        # serves the same tokens for the same prompt,
                        # like real greedy decode (hedge dedup, tier
                        # retries and migrations all assume it)
                        kwargs["stream_seed"] = sim_stream_seed(req.prompt)
                    if (
                        self._takes_seed
                        and getattr(req, "seed", None) is not None
                    ):
                        kwargs["seed"] = int(req.seed)
                    try:
                        self.batcher.submit(
                            seq, req.prompt, req.max_new_tokens,
                            getattr(req, "temperature", 0.0),
                            **kwargs,
                        )
                        self.by_seq[seq] = attempt
                        sink = getattr(req, "on_tokens", None)
                        if sink is not None:
                            # resume watermark: a hedge/retry/failover
                            # re-dispatch fast-forwards its EMISSION
                            # past tokens the caller already holds —
                            # the sequence still decodes from 0
                            base = int(getattr(
                                req, "resume_watermark", 0
                            ) or 0)
                            attempt.stream_base = base
                            self.sinks[seq] = sink
                            self.emitted[seq] = base
                    except Exception as e:  # noqa: BLE001 - bad request
                        attempt.finish(AttemptResult(False, error=str(e)))
                for attempt in self.cancels:
                    for seq, a in list(self.by_seq.items()):
                        if a is attempt:
                            self.batcher.cancel(seq)
                            del self.by_seq[seq]
                            self.sinks.pop(seq, None)
                            self.emitted.pop(seq, None)
                    attempt.finish(
                        AttemptResult(False, error="cancelled")
                    )
                self.cancels.clear()
                while self.ops:
                    fn, reply = self.ops.popleft()
                    try:
                        reply.put((True, fn()))
                    except Exception as e:  # noqa: BLE001 - op result
                        reply.put((False, e))
            # decode OUTSIDE the lock: a slow step (real JAX dispatch)
            # must not block submission/cancel delivery
            finished = self.batcher.serve_step()
            self._flush_sinks()
            # disaggregation: announce freshly-sealed (parked) sequences
            # to their attempt handles — the dispatcher's handoff trigger
            drain = getattr(self.batcher, "drain_sealed", None)
            if drain is not None:
                for seq in drain():
                    a = self.by_seq.get(seq)
                    if a is not None:
                        a.sealed.set()
            for seq, tokens in finished.items():
                # flush the tail BEFORE dropping by_seq: the sink gets
                # its attempt handle alongside the final delta
                self._flush_one(seq, list(tokens))
                attempt = self.by_seq.pop(seq, None)
                self.sinks.pop(seq, None)
                self.emitted.pop(seq, None)
                if attempt is not None:
                    attempt.finish(AttemptResult(True, tokens=list(tokens)))
            if self.step_delay_s:
                time.sleep(self.step_delay_s)
        # crashed: every in-flight attempt sees a connection reset
        for attempt in dead:
            attempt.finish(
                AttemptResult(False, error=f"replica {self.key} died")
            )

    def _flush_one(self, seq: int, tokens) -> None:
        """Emit a sequence's unseen committed tokens into its sink."""
        sink = self.sinks.get(seq)
        if sink is None:
            return
        done = self.emitted.get(seq, 0)
        if len(tokens) > done:
            self.emitted[seq] = len(tokens)
            attempt = self.by_seq.get(seq)
            try:
                sink(attempt, list(tokens[done:]))
            except Exception:  # noqa: BLE001 - sink is advisory
                pass

    def _flush_sinks(self) -> None:
        if not self.sinks:
            return
        live = getattr(self.batcher, "live_tokens", None)
        if live is None:
            return
        for seq, tokens in live().items():
            self._flush_one(seq, tokens)

    def submit(self, attempt: Attempt, request) -> None:
        with self.cond:
            if not self.alive:
                attempt.finish(AttemptResult(
                    False, error=f"replica {self.key} unreachable"
                ))
                return
            self.inbox.append((attempt, request))
            self.cond.notify()

    def cancel(self, attempt: Attempt) -> None:
        with self.cond:
            self.cancels.append(attempt)
            self.cond.notify()

    def control(self, fn, timeout: float = 30.0):
        """Run a closure on the worker thread between steps; returns its
        value or re-raises its exception.  Raises RuntimeError when the
        worker is dead (the caller treats it like a connection error)."""
        reply: "_queue.Queue" = _queue.Queue(1)
        with self.cond:
            if not self.alive:
                raise RuntimeError(f"replica {self.key} unreachable")
            self.ops.append((fn, reply))
            self.cond.notify()
        ok, val = reply.get(timeout=timeout)
        if not ok:
            raise val
        return val

    def kill(self) -> None:
        with self.cond:
            self.alive = False
            self.cond.notify()


class InMemoryReplicaClient(ReplicaClient):
    def __init__(
        self,
        batcher_factory: Optional[Callable[[str], object]] = None,
        step_delay_s: float = 0.0,
    ) -> None:
        """``batcher_factory``: builds a fresh batcher for a replica key —
        used by ``add_replica`` when no batcher is passed, and by
        ``sync_live`` to model a pod restarting with a cold cache after
        its chips come back."""
        self.batcher_factory = batcher_factory
        self.step_delay_s = step_delay_s
        self._lock = threading.Lock()
        self._workers: Dict[str, _ReplicaWorker] = {}
        # the brownout rung-2 cap in force (None = none): a replica that
        # cold-restarts WHILE the fleet is browned out must come up
        # capped too — set_brownout only fires on level crossings, so
        # the client re-applies the remembered cap at worker bring-up
        self._spec_cap: Optional[int] = None
        # request_id -> completed decode deliveries (soak's wasted-hedge
        # and exactly-once accounting reads this)
        self.decodes: Dict[str, int] = {}

    # -- replica lifecycle -------------------------------------------------
    def add_replica(self, key: str, batcher=None,
                    step_delay_s: Optional[float] = None) -> None:
        if batcher is None:
            if self.batcher_factory is None:
                raise ValueError("no batcher and no batcher_factory")
            batcher = self.batcher_factory(key)
        with self._lock:
            old = self._workers.get(key)
            worker = _ReplicaWorker(
                key, batcher,
                self.step_delay_s if step_delay_s is None else step_delay_s,
            )
            self._workers[key] = worker
            cap = self._spec_cap
        if old is not None:
            old.kill()
        if cap is not None:
            fn = getattr(worker.batcher, "set_speculation_cap", None)
            if fn is not None:
                try:
                    worker.control(lambda fn=fn: fn(cap))
                except Exception:  # noqa: BLE001 - advisory knob
                    pass

    def fail_replica(self, key: str) -> None:
        with self._lock:
            worker = self._workers.pop(key, None)
        if worker is not None:
            worker.kill()

    def set_step_delay(self, key: str, delay_s: float) -> None:
        """Straggler injection: slow one replica's decode loop down."""
        with self._lock:
            worker = self._workers.get(key)
        if worker is not None:
            worker.step_delay_s = delay_s

    def sync_live(self, live: FrozenSet[str]) -> None:
        """Registry subscription hook: a replica leaving the live set is
        its process dying (in-flight work errors out); one re-entering
        restarts cold via the factory."""
        with self._lock:
            known = set(self._workers)
        for key in known - set(live):
            self.fail_replica(key)
        if self.batcher_factory is not None:
            for key in set(live) - known:
                self.add_replica(key)

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._workers)

    def advertised(self) -> Dict[str, dict]:
        """Per-replica serving contract the data plane advertises
        upstream (duck-typed off each batcher): today the tensor-
        parallel width — a TP replica serves tp x the pool rows, which
        routing and autoscaling will want to weigh.  The ``GET /state``
        ``replica_mesh`` surface reads this."""
        with self._lock:
            workers = list(self._workers.items())
        return {
            key: {"tp": int(getattr(w.batcher, "tp", 1))}
            for key, w in workers
        }

    def ledgers(self, limit: int = 32) -> Dict[str, List[dict]]:
        """Recent per-iteration serving-ledger rows per replica, for
        batchers that keep one (duck-typed: the paged batcher's bounded
        ring; SimBatcher and the dense batcher have none).  The
        /debug/trace surface reads this."""
        with self._lock:
            workers = list(self._workers.items())
        out: Dict[str, List[dict]] = {}
        for key, w in workers:
            rows = getattr(w.batcher, "ledger_rows", None)
            if rows is not None:
                out[key] = rows(limit)
        return out

    def ready(self) -> bool:
        with self._lock:
            return bool(self._workers) or self.batcher_factory is not None

    def stop(self) -> None:
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.kill()

    # -- ReplicaClient -----------------------------------------------------
    def submit(self, replica_key: str, request) -> Attempt:
        attempt = Attempt(replica_key, request.request_id)
        attempt.request = request
        with self._lock:
            worker = self._workers.get(replica_key)
        if worker is None:
            attempt.finish(AttemptResult(
                False, error=f"replica {replica_key} unreachable"
            ))
            return attempt
        _original_finish = attempt.finish

        def counting_finish(result: AttemptResult) -> bool:
            first = _original_finish(result)
            if first and result.ok:
                with self._lock:
                    self.decodes[request.request_id] = (
                        self.decodes.get(request.request_id, 0) + 1
                    )
            return first

        attempt.finish = counting_finish  # type: ignore[method-assign]
        worker.submit(attempt, request)
        return attempt

    def cancel(self, attempt: Attempt) -> None:
        attempt.cancelled = True
        with self._lock:
            worker = self._workers.get(attempt.replica)
        if worker is not None:
            worker.cancel(attempt)
        else:
            attempt.finish(AttemptResult(False, error="cancelled"))

    # -- KV-page migration -------------------------------------------------
    def set_fail_migration(self, key: str, flag: bool) -> None:
        """Chaos knob: an armed replica refuses imports (the soak's
        importer-refusal schedule)."""
        with self._lock:
            worker = self._workers.get(key)
        if worker is not None:
            worker.fail_migration = flag

    def set_role(self, key: str, role: str) -> bool:
        """Disaggregation role actuator over the in-memory plane: flip
        one replica's batcher into (or out of) prefill-only serving
        mode, ON the serving thread.  Duck-typed — batchers without
        ``set_prefill_only`` (the dense batcher) stay co-located and
        report False.  The FleetController's ratio actuator pairs this
        with the registry's POD_ROLE annotation patch."""
        with self._lock:
            worker = self._workers.get(key)
        if worker is None:
            return False
        fn = getattr(worker.batcher, "set_prefill_only", None)
        if fn is None:
            return False
        try:
            worker.control(lambda: fn(role == "prefill"))
            return True
        except Exception:  # noqa: BLE001 - advisory knob
            return False

    def set_speculation(self, cap: Optional[int]) -> int:
        """Brownout rung 2 over the in-memory plane: apply a live
        speculation cap on every replica whose batcher supports one
        (duck-typed ``set_speculation_cap``), ON the serving thread —
        the batchers are single-driver."""
        with self._lock:
            self._spec_cap = cap
            workers = list(self._workers.values())
        adjusted = 0
        for w in workers:
            fn = getattr(w.batcher, "set_speculation_cap", None)
            if fn is None:
                continue
            try:
                if w.control(lambda fn=fn: fn(cap)):
                    adjusted += 1
            except Exception:  # noqa: BLE001 - advisory knob
                continue
        return adjusted

    def inflight_on(self, replica_key: str) -> List[Attempt]:
        with self._lock:
            worker = self._workers.get(replica_key)
        if worker is None:
            return []
        with worker.lock:
            return list(dict.fromkeys(worker.by_seq.values()))

    def seals_decode(self, replica_key: str) -> bool:
        with self._lock:
            worker = self._workers.get(replica_key)
        return worker is not None and bool(
            getattr(worker.batcher, "_seal_decode", False)
        )

    def export_sealed(self, replica_key: str, stream) -> Optional[dict]:
        with self._lock:
            worker = self._workers.get(replica_key)
        if worker is None or not hasattr(
            worker.batcher, "export_sealed_chain"
        ):
            return None
        try:
            return worker.control(
                lambda: worker.batcher.export_sealed_chain(stream)
            )
        except Exception:  # noqa: BLE001 - capture is best-effort
            return None

    def import_sealed(self, replica_key: str, payload) -> bool:
        if payload is None:
            return False
        with self._lock:
            worker = self._workers.get(replica_key)
        if worker is None or not hasattr(
            worker.batcher, "import_sealed_chain"
        ):
            return False
        try:
            return (
                worker.control(
                    lambda: worker.batcher.import_sealed_chain(payload)
                )
                or 0
            ) > 0
        except Exception:  # noqa: BLE001 - restore is best-effort
            return False

    # -- streamed seal-time handoff ----------------------------------------
    def export_delta(self, attempt: Attempt, request,
                     cursor: int) -> Optional[dict]:
        """Pages sealed since ``cursor`` on the attempt's replica, run
        ON its serving thread (read-only; single-driver batchers).
        None = nothing new, not streamable right now, or the replica
        is gone — streaming is best-effort by contract, so every
        failure mode degrades to the one-shot handoff."""
        with self._lock:
            src = self._workers.get(attempt.replica)
        if src is None or not hasattr(
            src.batcher, "export_sealed_delta"
        ):
            return None

        def op():
            seq = next(
                (s for s, a in src.by_seq.items() if a is attempt), None
            )
            if seq is None:
                return None
            return src.batcher.export_sealed_delta(seq, cursor)

        try:
            return src.control(op)
        except Exception:  # noqa: BLE001 - streaming is best-effort
            return None

    def import_delta(self, replica_key: str, payload) -> Optional[int]:
        """Stage a delta on the target's serving thread.  The returned
        count is the ACK the exporter's early reclaim keys off; None =
        refused (chaos knob, pool pressure, geometry) or unreachable —
        the dispatcher falls back to the one-shot transfer."""
        if payload is None:
            return None
        with self._lock:
            dst = self._workers.get(replica_key)
        if dst is None or not hasattr(
            dst.batcher, "import_sealed_delta"
        ):
            return None

        def op():
            if dst.fail_migration:
                raise RuntimeError("delta import refused (chaos knob)")
            return dst.batcher.import_sealed_delta(payload)

        try:
            return dst.control(op)
        except Exception:  # noqa: BLE001 - refusal = fall back
            return None

    def reclaim(self, attempt: Attempt, request, upto: int) -> int:
        with self._lock:
            src = self._workers.get(attempt.replica)
        if src is None or not hasattr(
            src.batcher, "reclaim_handoff_pages"
        ):
            return 0

        def op():
            seq = next(
                (s for s, a in src.by_seq.items() if a is attempt), None
            )
            if seq is None:
                return 0
            return src.batcher.reclaim_handoff_pages(seq, upto)

        try:
            return src.control(op) or 0
        except Exception:  # noqa: BLE001 - reclaim is best-effort
            return 0

    def migrate(self, attempt: Attempt, request, to_key: str,
                _between: Optional[Callable[[], None]] = None,
                fallback: bool = False, cursor: int = 0) -> bool:
        """Live migration over the in-memory plane: export + detach on
        the source worker's thread (atomic — no step can interleave),
        then import + re-register the SAME attempt on the target's.  A
        failed export leaves the sequence serving where it was; a
        failed import resolves the attempt with an error so normal
        failover re-dispatches it (cold — graceful, never wrong) —
        UNLESS ``fallback`` is set (the post-prefill handoff contract):
        then the held payload re-imports into the SOURCE, the sequence
        resumes decode where it prefilled, and the caller sees no error
        (``attempt.handoff_outcome`` says which way it went).  The
        source==target degenerate case is allowed under ``fallback``
        (detach-and-resume locally: a prefill replica with no decode
        peer unparks its own sequence through the same verb pair)."""
        with self._lock:
            src = self._workers.get(attempt.replica)
            dst = self._workers.get(to_key)
        if src is None or dst is None or attempt.done:
            return False
        if src is dst and not fallback:
            return False
        if not hasattr(src.batcher, "export_pages") or not hasattr(
            dst.batcher, "import_pages"
        ):
            return False
        trace = getattr(request, "trace", None)
        # overhang_ok: the migrated continuation's serve subtree nests
        # under this span, and its teardown may land after a hedge twin
        # already closed the request root — the same asynchrony the
        # dispatch spans carry
        mspan = (
            trace.child("migrate", source=attempt.replica, target=to_key,
                        overhang_ok=True)
            if trace is not None else None
        )
        attempt._migrating = True

        def export_op():
            seq = next(
                (s for s, a in src.by_seq.items() if a is attempt), None
            )
            if seq is None:
                raise KeyError("attempt not live on the source")
            payload = (src.batcher.export_pages(seq, cursor)
                       if cursor else src.batcher.export_pages(seq))
            # flush any tokens the export's pipeline drain just
            # committed, so the streaming relay misses nothing
            src._flush_sinks()
            src.batcher.cancel(seq)
            del src.by_seq[seq]
            src.sinks.pop(seq, None)
            src.emitted.pop(seq, None)
            return payload

        try:
            payload = src.control(export_op)
        except Exception:  # noqa: BLE001 - export failure = no migration
            if mspan is not None:
                mspan.end(outcome="export_failed")
            return False
        if _between is not None:
            _between()   # fault injection: kill-mid-migration schedules

        attempt.handoff_wire_bytes = _payload_nbytes(payload)

        def import_into(w: "_ReplicaWorker", chaos: bool):
            def op():
                if chaos and w.fail_migration:
                    raise RuntimeError("migration refused (chaos knob)")
                seq = w._next_seq
                w._next_seq += 1
                # the continuation's serve subtree nests under the
                # migrate span (overhang-exempt): its teardown may
                # legitimately outlive the request root
                w.batcher.import_pages(seq, payload, trace=mspan)
                w.by_seq[seq] = attempt
                sink = getattr(request, "on_tokens", None)
                if sink is not None:
                    w.sinks[seq] = sink
                    w.emitted[seq] = len(payload.get("tokens") or [])

            w.control(op)

        try:
            import_into(dst, chaos=True)
        except Exception as e:  # noqa: BLE001 - import failure = result
            if fallback:
                # the handoff-fallback contract: the decode side refused
                # (pool pressure, dtype skew, chaos) or died between
                # export and import ack — resume decode ON the source.
                # The source's import_pages marks the sequence imported,
                # so a prefill-only batcher decodes it instead of
                # re-parking (never a request error).
                try:
                    import_into(src, chaos=False)
                except Exception as e2:  # noqa: BLE001 - now it IS one
                    attempt.finish(AttemptResult(
                        False,
                        error=f"migration import failed: {e}; "
                              f"fallback failed: {e2}",
                    ))
                    if mspan is not None:
                        mspan.end(outcome="fallback_failed")
                    return False
                attempt.handoff_outcome = "fallback"
                if mspan is not None:
                    mspan.end(outcome="fallback",
                              pages=len(payload.get("page_keys") or []))
                return True
            attempt.finish(AttemptResult(
                False, error=f"migration import failed: {e}"
            ))
            if mspan is not None:
                mspan.end(outcome="import_failed")
            return False
        attempt.replica = to_key
        if fallback:
            # a post-prefill handoff landed; src==dst (the collapse
            # rung's local unpark) crossed no replica boundary and must
            # not read as a disaggregated handoff.  Plain migrations
            # (drains, the soak's bare op) leave the outcome untouched.
            attempt.handoff_outcome = "fallback" if src is dst else "ok"
        if mspan is not None:
            mspan.end(outcome="ok",
                      pages=len(payload.get("page_keys") or []))
        return True
