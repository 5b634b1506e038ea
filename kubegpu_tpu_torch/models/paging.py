"""Paged KV serving: continuous batching over a shared page pool — the
port of ``kubegpu_tpu/models/paging.py`` for greedy and sampled serving
over a full-width or int8 pool.

- ``PagedDecodeLM``: the paged twin of ``DecodeLM`` with the same
  parameter tree, whose per-layer cache is a
  ``(pool_pages, heads, page, head_dim)`` pool plus a per-slot page
  table; one token per slot attends through
  :func:`paged_decode_attention` (K1 on the card), a speculative verify
  window of k+1 tokens through :func:`paged_chunk_attention` (K2).
- ``PrefixPageCache``: content-hash -> physical page map with refcounts
  and LRU eviction (plain Python, as in the JAX package).
- ``PagedContinuousBatcher``: the serving loop.  Prompts prefill in
  page-sized chunks through a dense multi-slot STATION (``DecodeLM``),
  each finished station page is scattered into freshly reserved pool
  pages, full prompt pages are registered in the prefix cache, and
  every decode step runs ``PagedDecodeLM`` over all slots.  With
  ``speculate_k`` a dense draft proposes k tokens per slot from its own
  ring cache and one verify window scores them; greedy verification
  makes the streams the non-speculative ones for any draft.  With
  ``decode_page_cache`` a retiring sequence's complete pages, prompt and
  generated, seal into the prefix chain.

Sampling draws the JAX package's bits (``ops/prng.py``), so seed-pinned
sampled streams equal the JAX batcher's at float32.  A request with
``temperature > 0`` samples each token with the key ``fold_in(base,
count + offset)``: a request pinning ``seed`` has base ``PRNGKey(seed)``
and offset ``plen`` (the key folds the token's absolute position),
others ``fold_in(PRNGKey(batcher seed), seq_id)`` and offset 0.  Under
speculation with ``sampling=True`` a sampled slot's first token is a
direct target sample, its draft proposals sample, and the verify runs
per-position rejection sampling, every draw keyed by the absolute
position and a tag (``decoding.position_key``).  The per-slot
temperature, base key, key offset and count live in fixed device
tensors written at admission; no step reads them on the host.

The int8 pool (``kv_dtype="int8"``): each layer's K and V are ``(data,
scale)`` pairs, int8 ``(pool_pages, heads, page, head_dim)`` pages and
``(pool_pages, heads)`` float32 per-page, per-head scales; the kernels
(K1q, K2q) dequantize as they read.  Three write rules keep the bytes a
pure function of the traffic, as in the JAX package: station scatters
quantize each page whole at its tight scale (rows past the prompt
masked to zero); decode and verify rows commit one at a time through
:func:`_quant_write_row` (grow-and-rescale); sealing requantizes a page
to its tight scale before it enters the shared chain.  Fresh pages start
at scale 0.  Under speculation the draft ring is int8 too, dequantized
whole before each draft scan and requantized whole after.  ``quant=True``
serves weight-only int8 weights (``QuantDense``).

Numerics, as in the JAX package: the paged kernel scores and softmaxes
in f32 while the dense station scores in the model dtype; at float32 the
two agree to rounding and greedy streams match the JAX batcher token for
token.

The decode loop state (last tokens, tables, positions, active mask,
remaining budgets) lives in device tensors and advances inside the step,
termination included.  With ``pipeline_decode`` the host reads each
step's tokens one iteration late: the readback is a ``non_blocking``
copy into pinned host memory plus a CUDA event, so the next step is
enqueued before the host waits.  Pools, station caches and the loop
state are updated in place where they lie.

Migration and disaggregation, as in the JAX package: ``export_pages``
reads a live sequence's committed pages, chain keys and decode cursor
to host numpy (read-only), ``import_pages`` resumes it in another
batcher (atomic: every check runs before the first refcount moves);
``export_sealed_chain``/``import_sealed_chain`` carry a finished
stream's sealed pages, and ``export_sealed_delta``/``import_sealed_delta``
/``reclaim_handoff_pages`` stream a prefill-only replica's sealed prompt
pages while it still prefills.  ``prefill_only=True`` parks each
sequence the moment its prompt pages seal: its lane stays inactive on
the device and ``drain_sealed`` announces it once.  A payload's pages
are host numpy in the JAX payload's layout: float32 and int8 pools as
such, a bfloat16 pool's pages as their raw 16-bit patterns
(``np.uint16``), which the importer also takes from any 2-byte array
whose dtype is named ``bfloat16``.
"""

from __future__ import annotations

import hashlib
import time
import warnings
from collections import OrderedDict, deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from kubegpu_tpu_torch.models.decoding import (
    KEY_TAG_SAMPLE,
    DecodeAttention,
    DecodeBlock,
    DecodeLM,
    LMBase,
    head_f32,
    init_caches,
    pick_tokens,
    pick_with_noise,
    position_key,
)
from kubegpu_tpu_torch.models.params import bind_params, resolve_device, tree_map
from kubegpu_tpu_torch.models.serving import (
    _observe_emit,
    _SeqTrace,
    _TracedBatcher,
    resolve_decode_page_cache,
    resolve_kv_dtype,
    validate_request,
)
from kubegpu_tpu_torch.models.speculative import sampled_verify, window_keys
from kubegpu_tpu_torch.ops import prng
from kubegpu_tpu_torch.ops.paged_attention import (
    check_chunk_args,
    check_kernel_args,
    dequantize_pages,
    paged_chunk_attention,
    paged_decode_attention,
    quantize_pages,
)

Pools = List[tuple]


def pool_operands(k_entry, v_entry):
    """``(k pool, v pool, k scales, v scales)`` of one layer's pool
    entries: ``(data, scale)`` pairs for an int8 pool, plain pools with
    scales None at full width."""
    if isinstance(k_entry, tuple):
        return k_entry[0], v_entry[0], k_entry[1], v_entry[1]
    return k_entry, v_entry, None, None


def _quant_write_row(data, scale, page_ids, offs, rows) -> None:
    """Commit one row per slot into an int8 pool, in place: ``data``
    (P, h, page, hd) int8, ``scale`` (P, h) float32, ``page_ids``/``offs``
    (b,) the slot's page and row, ``rows`` (b, h, hd) the new K or V.
    The grow-and-rescale rule of the JAX package's ``_quant_write_row``:
    a page's scale only grows (``max(old, row_amax / 127)``), and when it
    grows the page's int8 values are rescaled by old/new in the same
    gather-rescale-scatter — so the same history of writes gives the
    same bytes.  A zero scale (a fresh page) wipes whatever int8 the page
    held.  Idle slots all write the dump page 0: their duplicate indices
    land in no fixed order on the card, and page 0 is never read for a
    live sequence."""
    b = rows.shape[0]
    rowf = rows.float()
    amax = rowf.abs().amax(-1)                              # (b, h)
    cur_s = scale[page_ids]                                 # (b, h)
    new_s = torch.maximum(cur_s, amax / 127.0)
    safe = torch.where(new_s > 0, new_s, 1.0)
    ratio = cur_s / safe                                    # <= 1
    cur = torch.round(data[page_ids].float() * ratio[:, :, None, None])
    qrow = torch.clamp(torch.round(rowf / safe[:, :, None]), -127, 127)
    cur[torch.arange(b, device=rows.device), :, offs, :] = qrow
    data[page_ids] = cur.to(torch.int8)
    scale[page_ids] = new_s


def requantize_tight(data, scale) -> tuple:
    """Seal-time requantization of int8 pages ``data`` (n, h, page, hd)
    with scales (n, h): stretch each head's values back to full range,
    ``round(x * 127 / max|x|)``, and shrink its scale by ``max|x| / 127``
    — the dequantized values keep to rounding while the step tightens to
    the page's content.  All-zero heads and pages already at 127 pass
    through unchanged.  Returns the new ``(data, scale)``."""
    blk = data.float()
    mx = blk.abs().amax(dim=(2, 3))                         # (n, h)
    mxs = torch.where(mx > 0, mx, 127.0)
    newd = torch.clamp(torch.round(blk * (127.0 / mxs)[:, :, None, None]),
                       -127, 127)
    news = scale * mxs / 127.0
    ok = mx > 0
    return (torch.where(ok[:, :, None, None], newd, blk).to(torch.int8),
            torch.where(ok, news, scale))


def quantize_ring(full, cur_scale=None) -> tuple:
    """An int8 draft ring lane set from full-width rows ``full`` (slots,
    rows, h, hd): per-(slot, head) scales ``amax / 127``, grown from
    ``cur_scale`` when given (the grow-and-rescale rule over the whole
    ring: an unchanged scale round-trips every unchanged row).  Returns
    ``(int8 data, (slots, h) float32 scales)``."""
    f = full.float()
    new_s = f.abs().amax(dim=(1, 3)) / 127.0
    if cur_scale is not None:
        new_s = torch.maximum(cur_scale, new_s)
    safe = torch.where(new_s > 0, new_s, 1.0)
    q = torch.clamp(torch.round(f / safe[:, None, :, None]), -127, 127)
    return q.to(torch.int8), new_s


class PagedDecodeAttention(DecodeAttention):
    """Attention over a paged KV pool (parameter names as the dense
    twin's).  The window's K/V rows are written to the slot's pages first
    (in place), then window row j attends rows ``< pos + 1 + j``: one
    token (L == 1) is a decode step through K1, a wider window a
    speculative verify through K2 — K1q and K2q over an int8 pool, whose
    entries are ``(data, scale)`` pairs and whose rows commit one at a
    time through :func:`_quant_write_row`."""

    def forward(self, x, k_pool, v_pool, table, pos, checked=False):
        # x (b, L, d); pools (P, h, page, hd), or (data, scale) pairs;
        # table (b, n_pages) int32; pos (b,) int32 cache row of the
        # window's first token; checked: the kernel's operand checks
        # already ran on this layout
        if isinstance(k_pool, tuple):
            return self._forward_int8(x, k_pool, v_pool, table, pos, checked)
        b, L, d = x.shape
        h = self.num_heads
        hd = d // h
        page = k_pool.shape[2]
        if L == 1:
            q = self.q_proj(x).view(b, h, hd)
            k = self.k_proj(x).view(b, h, hd)
            v = self.v_proj(x).view(b, h, hd)
            rows = torch.arange(b, device=x.device)
            page_ids = table[rows, pos // page]
            offs = pos % page
            k_pool[page_ids, :, offs, :] = k
            v_pool[page_ids, :, offs, :] = v
            out = paged_decode_attention(q, k_pool, v_pool, table, pos + 1,
                                         checked=checked)
            return self.o_proj(out.reshape(b, 1, d))
        q = self.q_proj(x).view(b, L, h, hd)
        k = self.k_proj(x).view(b, L, h, hd)
        v = self.v_proj(x).view(b, L, h, hd)
        # window row j lands at cache row pos + j: one index-put over
        # (b, L); rejected rows are junk the next window overwrites
        # before any mask exposes them
        cache_rows = pos.long()[:, None] + torch.arange(L, device=x.device)
        slots = torch.arange(b, device=x.device)[:, None]
        page_ids = table[slots, cache_rows // page]
        offs = cache_rows % page
        k_pool[page_ids, :, offs, :] = k
        v_pool[page_ids, :, offs, :] = v
        out = paged_chunk_attention(q, k_pool, v_pool, table, pos + 1,
                                    checked=checked)
        return self.o_proj(out.reshape(b, L, d))

    def _forward_int8(self, x, k_entry, v_entry, table, pos, checked):
        b, L, d = x.shape
        h = self.num_heads
        hd = d // h
        (kd, ks), (vd, vs) = k_entry, v_entry
        page = kd.shape[2]
        q = self.q_proj(x).view(b, L, h, hd)
        k = self.k_proj(x).view(b, L, h, hd)
        v = self.v_proj(x).view(b, L, h, hd)
        # one row at a time: a scale growth mid-window rescales the rows
        # written before it, as the JAX program's unrolled writes do
        slots = torch.arange(b, device=x.device)
        for j in range(L):
            row = pos.long() + j
            page_ids = table[slots, row // page]
            _quant_write_row(kd, ks, page_ids, row % page, k[:, j])
            _quant_write_row(vd, vs, page_ids, row % page, v[:, j])
        if L == 1:
            out = paged_decode_attention(q[:, 0], kd, vd, table, pos + 1,
                                         k_scale=ks, v_scale=vs,
                                         checked=checked)
        else:
            out = paged_chunk_attention(q, kd, vd, table, pos + 1,
                                        k_scale=ks, v_scale=vs,
                                        checked=checked)
        return self.o_proj(out.reshape(b, L, d))


class PagedDecodeBlock(DecodeBlock):
    attn_cls = PagedDecodeAttention


class PagedDecodeLM(LMBase):
    """Paged twin of ``DecodeLM`` for decode steps and verify windows:
    ``forward(tokens (b, L), pools [(k, v)] per layer, table, pos (b,))``
    writes each slot's L K/V rows into its pages in place and returns
    the last row's float32 logits ``(b, vocab)``, or every row's
    ``(b, L, vocab)`` when built with ``all_logits=True`` (the verify).
    ``pos`` is the cache row of the first token; each pool is a
    ``(data, scale)`` pair for an int8 pool.  ``checked=True`` skips the
    attention kernels' per-call operand checks (the batcher runs them
    once)."""

    block_cls = PagedDecodeBlock

    def forward(self, tokens, pools: Pools, table, pos,
                checked: bool = False) -> torch.Tensor:
        L = tokens.shape[1]
        pos_rows = pos.long()[:, None]
        if L > 1:
            pos_rows = pos_rows + torch.arange(L, device=tokens.device)
        x = self.embed_rows(tokens, pos_rows)
        for block, (kp, vp) in zip(self.blocks(), pools):
            x = block(x, kp, vp, table, pos, checked)
        logits = self.head(x)
        return logits if self.all_logits else logits[:, -1]


class PrefixPageCache:
    """Content-hash -> physical page map with refcounts and LRU eviction.

    A page is live while any sequence references it (refcount > 0); at
    refcount 0 it stays cached — a later same-prefix request can still
    hit it — and becomes evictable in LRU order when the pool needs
    pages.  Host-side accounting only; the K/V bytes live in the pool.
    Every entry carries a ``kind`` (``"prompt"`` for station-sealed
    pages, ``"decode"`` for pages sealed at retirement whose rows hold
    decode-written K/V), and the key of its chain predecessor, which
    ``chains()`` counts for ``/v1/state``."""

    def __init__(self) -> None:
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self._refs: Dict[int, int] = {}
        self._key_of: Dict[int, bytes] = {}
        self._kind_of: Dict[int, str] = {}
        # content-chain predecessor per entry (key j-1 of the same
        # cumulative hash chain; None for a chain head).  Advisory:
        # eviction can punch LRU holes mid-chain, which splits the chain
        # in the count, exactly as admission sees it
        self._prev: Dict[bytes, Optional[bytes]] = {}

    def lookup(self, key: bytes) -> Optional[int]:
        """Peek without taking a reference (admission feasibility)."""
        return self._entries.get(key)

    def acquire(self, key: bytes) -> Optional[int]:
        page = self._entries.get(key)
        if page is None:
            return None
        self._entries.move_to_end(key)
        self._refs[page] += 1
        return page

    def insert(self, key: bytes, page: int, kind: str = "prompt",
               prev: Optional[bytes] = None) -> None:
        """Register a freshly sealed page; the caller holds one ref.
        ``prev`` is the chain's preceding page key (None for page 0)."""
        assert key not in self._entries, "duplicate prefix key"
        assert page not in self._refs, "page already cached"
        assert kind in ("prompt", "decode"), f"unknown page kind {kind!r}"
        self._entries[key] = page
        self._refs[page] = 1
        self._key_of[page] = key
        self._kind_of[page] = kind
        self._prev[key] = prev

    def release(self, page: int) -> None:
        self._refs[page] -= 1
        assert self._refs[page] >= 0, f"refcount underflow on page {page}"

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def kind_of(self, page: int) -> str:
        return self._kind_of[page]

    def idle_count(self) -> int:
        return sum(1 for r in self._refs.values() if r == 0)

    def evict_lru(self) -> Optional[int]:
        """Drop the least-recently-used refcount-0 entry; returns its page
        (now unowned) or None if everything is referenced."""
        for key, page in self._entries.items():
            if self._refs[page] == 0:
                del self._entries[key]
                del self._refs[page]
                del self._key_of[page]
                del self._kind_of[page]
                self._prev.pop(key, None)
                return page
        return None

    def pages(self) -> Set[int]:
        return set(self._refs)

    def chains(self) -> int:
        """Distinct cached chains: entries no present entry names as its
        predecessor (chain tails; divergent suffixes over one shared
        prefix count once each, an LRU hole splits a chain in two — how
        admission's longest-unbroken-prefix probe sees the cache)."""
        referenced = {
            p for k, p in self._prev.items()
            if k in self._entries and p is not None and p in self._entries
        }
        return sum(1 for k in self._entries if k not in referenced)

    def pages_by_kind(self) -> Dict[str, int]:
        out = {"prompt": 0, "decode": 0}
        for kind in self._kind_of.values():
            out[kind] += 1
        return out

    def assert_consistent(self) -> None:
        """entries/refs/keys/kinds describe exactly the same page set, and
        every entry's reverse mapping agrees."""
        assert set(self._refs) == set(self._key_of) == set(self._kind_of), (
            "cache maps diverged: "
            f"refs={sorted(self._refs)} keys={sorted(self._key_of)} "
            f"kinds={sorted(self._kind_of)}"
        )
        assert len(self._entries) == len(self._refs), "entry/page count mismatch"
        for key, page in self._entries.items():
            assert self._key_of[page] == key, f"page {page} key drifted"

    def __len__(self) -> int:
        return len(self._entries)


def chain_keys(stream: np.ndarray, page: int, n_full: int) -> List[bytes]:
    """Prefix-chain keys of a stream's first ``n_full`` full pages: one
    sha256 over the stream, its digest snapshotted at every page
    boundary (key j hashes every token through page j — a row's K/V
    depends on every token before it)."""
    h = hashlib.sha256()
    keys: List[bytes] = []
    for j in range(n_full):
        h.update(stream[j * page: (j + 1) * page].tobytes())
        keys.append(h.copy().digest())
    return keys


@dataclass
class _Seq:
    seq_id: int = -1
    remaining: int = 0
    active: bool = False
    prefilling: bool = False     # a _PrefillJob is feeding this slot
    temperature: float = 0.0     # > 0: the slot samples
    tokens: List[int] = field(default_factory=list)
    # the activated prompt, for retirement sealing's chain keys
    prompt: Optional[np.ndarray] = None
    plen: int = 0
    pages: List[int] = field(default_factory=list)  # reserved physical ids
    shared: Set[int] = field(default_factory=set)   # cache-owned subset
    submitted_at: float = 0.0
    last_emit_at: float = 0.0
    # bumped every time the slot is (re)assigned, so a pipelined
    # in-flight step's results are never credited to a later occupant
    gen: int = 0
    # slot-owned trace state from admission to retirement (see
    # _TracedBatcher's ownership model); None when untraced
    trace: Optional[_SeqTrace] = None
    # host copies of the slot's sampling keys, for export: the base key
    # (two uint32 words) and the key-index offset
    base_key: Tuple[int, int] = (0, 0)
    key_offset: int = 0
    # prefill-only serving: the prompt's pages sealed with zero tokens
    # emitted and the lane is withheld from the step; it waits for an
    # export (the handoff) or a local unpark
    parked: bool = False
    # streamed-handoff early reclaim: page indices [0, reclaimed_upto)
    # went back to the pool once the importer acked their deltas; they
    # stay in ``pages`` so the final export keeps absolute indexing, and
    # release and accounting skip them
    reclaimed_upto: int = 0


@dataclass
class _PrefillJob:
    """One in-flight chunked admission through a prefill-station slot."""

    slot: int                # sequence slot being fed
    station: int             # station slot holding this job's dense rows
    seq_id: int
    prompt: np.ndarray
    plen: int
    keys: List[bytes]        # chain hashes of sharable full prompt pages
    pos: int                 # prompt rows already prefilled (or cached)
    next_scatter: int        # next page index to scatter from the station
    started: bool = False    # its first chunk ran (prefill wait observed)
    temperature: float = 0.0
    seed: Optional[int] = None   # pins the request's sample stream


@dataclass
class _Inflight:
    """One dispatched-but-unread decode iteration: ``toks`` is the host
    copy of its int32 results (valid once ``event`` has completed, or at
    once on the CPU) — a plain step's tokens ``(slots,)``, or a
    speculative iteration's ``(slots, k + 3)`` pack of the window's
    choices, the emitted length and the ring-wrap flag; ``cand`` maps
    slot -> its admission generation at dispatch; ``td0``/``tv0``/``tv1``
    stamp a speculative iteration's draft and verify dispatch windows
    (its trace spans)."""

    cand: Dict[int, int]
    toks: torch.Tensor
    event: Optional[torch.cuda.Event] = None
    td0: float = 0.0
    tv0: float = 0.0
    tv1: float = 0.0


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as the JAX package writes it ("float32",
    "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _host_pairs(t: torch.Tensor) -> List[tuple]:
    """A ``(layers, 2, ...)`` device tensor as per-layer ``(k, v)`` host
    numpy arrays, in one device-to-host copy.  bfloat16 has no numpy
    dtype: its values cross as their raw 16-bit patterns (``np.uint16``)."""
    if t.dtype == torch.bfloat16:
        host = t.view(torch.int16).cpu().numpy().view(np.uint16)
    else:
        host = t.cpu().numpy()
    return [(host[i, 0], host[i, 1]) for i in range(host.shape[0])]


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` of a host array the caller only reads: a
    decoded wire payload's arrays are read-only views of their bytes."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _host_tensor(arr, dtype: torch.dtype) -> torch.Tensor:
    """A transferred host array as a CPU tensor of the storage ``dtype``.
    A bfloat16 store takes raw 16-bit patterns (``uint16``/``int16``, or
    any 2-byte dtype named ``bfloat16``) as they are and rounds float
    values; an int8 store takes int8 only, a float32 store floats only.
    Anything else raises ``ValueError``."""
    a = np.asarray(arr)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and (
            a.dtype.name == "bfloat16" or a.dtype.kind in "iu"):
        return _from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if dtype == torch.int8 and a.dtype == np.int8:
        return _from_numpy(a)
    if dtype != torch.int8 and a.dtype.kind == "f":
        return _from_numpy(a.astype(np.float32, copy=False)).to(dtype)
    raise ValueError(
        f"malformed payload: a {a.dtype} array cannot hold this pool's "
        f"{_dtype_name(dtype)} pages"
    )


def _not_ported(knob: str, arrives_with: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported yet: it arrives with {arrives_with}"
    )


def _validate_speculation(k, draft_window, draft_params, draft_num_layers,
                          draft_num_heads, draft_hidden, max_seq: int,
                          prompt_pad: int) -> Optional[int]:
    """The JAX batcher's speculation contract; returns the draft ring's
    row count (None without speculation).  The ring defaults to the
    lesser of ``max_seq`` and ``prompt_pad + 16 * (k + 1)`` and must hold
    a full prompt plus one verify window."""
    if k is None:
        if draft_window is not None:
            raise ValueError(
                "draft_window requires speculate_k: only the speculative "
                "draft has a ring cache to bound"
            )
        return None
    if k < 1:
        raise ValueError(f"speculate_k ({k}) must be >= 1 or None")
    if draft_params is None or None in (
        draft_num_layers, draft_num_heads, draft_hidden
    ):
        raise ValueError(
            "speculate_k needs a draft model: pass draft_params "
            "with draft_num_layers/draft_num_heads/draft_hidden"
        )
    if k + 1 > max_seq:
        raise ValueError(
            f"speculate_k ({k}) verify window exceeds max_seq ({max_seq})"
        )
    if draft_window is None:
        draft_window = min(max_seq, prompt_pad + 16 * (k + 1))
    if draft_window > max_seq:
        raise ValueError(
            f"draft_window ({draft_window}) exceeds max_seq "
            f"({max_seq}): rows past the longest stream are waste"
        )
    floor = min(max_seq, prompt_pad + k + 1)
    if draft_window < floor:
        raise ValueError(
            f"draft_window ({draft_window}) must cover a full "
            f"prompt plus one verify window: >= {floor} "
            f"(min(max_seq, prompt_pad + speculate_k + 1))"
        )
    return draft_window


TP_SLICE = "the tensor-parallel slice"


class PagedContinuousBatcher(_TracedBatcher):
    """Greedy continuous batching with a shared KV page pool and prefix
    reuse — the JAX package's ``PagedContinuousBatcher`` at full width.

    ``pool_pages`` bounds total cache memory across all slots (page 0 is
    the permanent dump page); each admitted sequence reserves exactly
    ``ceil((prompt + budget) / page)`` pages and returns them at
    retirement.  Admission is FIFO and defers while the pool lacks the
    reservation (refcount-0 prefix-cache pages count as available and
    are LRU-evicted on demand); a request whose worst case exceeds the
    whole pool is rejected at submit.  ``station_slots`` admissions
    prefill concurrently, each advancing ``prefill_chunk`` rows per
    serving iteration in page-sized chunks; ``token_budget`` bounds the
    rows one iteration processes (active decode tokens + chunk rows, at
    least one chunk always runs).  ``prefix_cache=False`` makes every
    page private.  ``pipeline_decode`` (default) keeps one decode step in
    flight and reads its tokens after dispatching the next; ``False`` is
    the synchronous loop (state uploaded from host mirrors every step),
    the oracle the pipelined loop must match token for token.

    ``kv_dtype="int8"`` stores the pool as int8 pages with per-page,
    per-head float32 scales (the module docstring has the write rules);
    ``quant=True`` takes a :func:`quantize_params_int8` tree.
    ``decode_page_cache`` (``"off"``, ``"fp32"``, ``"quantized"``,
    ``"all"``) lets retirement seal a sequence's complete pages, prompt
    and generated, into the prefix chain when the policy trusts the
    pool's numerics class (``models/serving.py``); an int8 pool
    requantizes each page to its tight scale as it seals.

    ``speculate_k`` with ``draft_params`` and its ``draft_num_layers``/
    ``draft_num_heads``/``draft_hidden`` turns on greedy speculative
    decoding: each iteration the draft proposes k tokens per active slot
    (k+1 scan steps over a dense ``slots x draft_window`` ring), and one
    verify window of k+1 rows per slot (K2) accepts the longest prefix
    matching the target's greedy choices plus one token.  Each admitted
    sequence reserves k more rows of pages, for the verify window's junk
    tail; a token budget bills k+1 rows per active slot.

    ``top_k`` truncates every sampled draw to the k largest logits.  A
    request ``submit``-ted with ``temperature > 0`` samples (``seed``
    pins its stream); a speculative batcher samples only when built with
    ``sampling=True`` and refuses sampled requests otherwise.  ``seed``
    roots the keys of requests that pin none.

    Observability, as in the JAX package: ``metrics`` (a
    ``utils.metrics.Metrics``) receives the ``serve_*`` series of
    ``utils/metric_names.py``; ``tracer`` (a ``utils.tracing.Tracer``),
    or a ``trace`` context passed to ``submit``, gives each request a
    ``serve`` subtree (queue, prefix_gather, station_wait, prefill with
    its chunks, decode with its spec_draft/spec_verify children, one
    retire); every ``serve_step`` appends a row to a ledger of the last
    ``ledger_size`` iterations (``ledger_rows``), whose ``device_ms`` is
    the time the loop blocked on its token readback and ``host_ms`` the
    rest of the iteration.

    ``prefill_only=True`` (a disaggregated fleet's prefill replica)
    parks every sequence the moment its prompt pages seal, with zero
    tokens emitted; ``drain_sealed`` announces each once, the migration
    verbs hand it to a decode replica, and ``set_prefill_only(False)``
    unparks it locally.

    The constructor keeps the JAX signature.  ``mesh`` (tensor
    parallelism) raises ``NotImplementedError`` naming its slice.
    ``device`` defaults to ``"cuda"`` and raises without a card; the CPU
    runs only when asked for (``device="cpu"``)."""

    def __init__(
        self,
        params,
        *,
        vocab_size: int,
        num_layers: int,
        num_heads: int,
        hidden: int,
        max_seq: int,
        slots: int = 8,
        prompt_pad: int = 128,
        page_size: int = 128,
        pool_pages: int = 64,
        prefill_chunk: Optional[int] = None,
        station_slots: Optional[int] = None,
        token_budget: Optional[int] = None,
        prefix_cache: bool = True,
        decode_page_cache: str = "off",
        kv_dtype: Optional[str] = None,
        pipeline_decode: bool = True,
        eos_id: Optional[int] = None,
        dtype=torch.bfloat16,
        quant: bool = False,
        top_k: int = 0,
        seed: int = 0,
        metrics=None,
        tracer=None,
        ledger_size: int = 512,
        draft_params=None,
        draft_num_layers: Optional[int] = None,
        draft_num_heads: Optional[int] = None,
        draft_hidden: Optional[int] = None,
        speculate_k: Optional[int] = None,
        draft_window: Optional[int] = None,
        sampling: bool = False,
        mesh=None,
        prefill_only: bool = False,
        device="cuda",
    ) -> None:
        if mesh is not None:
            raise _not_ported("mesh", TP_SLICE)
        if prompt_pad > max_seq:
            raise ValueError(
                f"prompt_pad ({prompt_pad}) exceeds max_seq ({max_seq})"
            )
        if top_k > vocab_size:
            raise ValueError(
                f"top_k ({top_k}) exceeds vocab_size ({vocab_size})"
            )
        if prompt_pad % page_size:
            raise ValueError(
                f"prompt_pad ({prompt_pad}) must be a multiple of "
                f"page_size ({page_size}): the admit scatter copies whole "
                "pages out of the dense prefill cache"
            )
        if prefill_chunk is None:
            prefill_chunk = page_size
        if prefill_chunk <= 0 or prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive "
                f"multiple of page_size ({page_size}): station writes are "
                "page-aligned"
            )
        self._chunks_per_step = prefill_chunk // page_size
        if station_slots is None:
            station_slots = slots
        if station_slots < 1:
            raise ValueError(f"station_slots ({station_slots}) must be >= 1")
        self.station_slots = station_slots
        if token_budget is not None and token_budget <= 0:
            raise ValueError(
                f"token_budget ({token_budget}) must be positive or None"
            )
        self.token_budget = token_budget
        self.kv_quant = resolve_kv_dtype(kv_dtype, dtype)
        self.kv_dtype = ("int8" if self.kv_quant
                         else str(dtype).replace("torch.", ""))
        self.draft_window = _validate_speculation(
            speculate_k, draft_window, draft_params, draft_num_layers,
            draft_num_heads, draft_hidden, max_seq, prompt_pad,
        )
        self.speculate_k = speculate_k
        # rejection-sampled speculation; without speculate_k the flag is
        # inert (plain paged decode samples any request with a
        # temperature)
        self.sampling = bool(sampling) and speculate_k is not None
        self.top_k = top_k
        # the root of unpinned requests' keys, kept on the host: a
        # request's base key is derived at admission and copied once
        self._root_key = prng.PRNGKey(seed)
        self.decode_page_cache = decode_page_cache
        self._seal_decode = (
            resolve_decode_page_cache(decode_page_cache, dtype, self.kv_quant)
            and prefix_cache
        )
        self.device = dev = resolve_device(device)
        # the stream the batcher's work is ordered on; a serving thread
        # other than this one binds it before it steps the batcher
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)
        self.metrics = None
        self.tracer = tracer
        self._traces: Dict[int, _SeqTrace] = {}
        self._ledger: deque = deque(maxlen=ledger_size)
        self.tp = 1
        self._last_prefill_rows = 0
        self._sync_wait_s = 0.0
        self.slots = slots
        self.prompt_pad = prompt_pad
        self.page = page_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.max_pages = -(-max_seq // page_size)  # table width per slot
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden = hidden
        self.dtype = dtype
        self.pipeline_decode = pipeline_decode
        hd = hidden // num_heads

        params = head_f32(tree_map(lambda t: t.to(dev), params), quant)
        model_cfg = dict(vocab_size=vocab_size, num_layers=num_layers,
                         num_heads=num_heads, hidden=hidden, dtype=dtype,
                         quant=quant)
        self.model = bind_params(
            PagedDecodeLM(max_seq=max_seq, **model_cfg), params
        )
        # the dense twin prefills prompts through the station; its
        # position table is the target's, cut to the station's rows
        station_params = dict(params, pos_embed={
            "embedding": params["pos_embed"]["embedding"][:prompt_pad]
        })
        self.dense_model = bind_params(
            DecodeLM(max_seq=prompt_pad, **model_cfg), station_params
        )
        def pool_side():
            if self.kv_quant:
                return (torch.zeros((pool_pages, num_heads, page_size, hd),
                                    dtype=torch.int8, device=dev),
                        torch.zeros((pool_pages, num_heads),
                                    dtype=torch.float32, device=dev))
            return torch.zeros((pool_pages, num_heads, page_size, hd),
                               dtype=dtype, device=dev)

        self.pools = [(pool_side(), pool_side()) for _ in range(num_layers)]
        # the pool's resting bytes by storage dtype (int8 pages plus f32
        # scales, or full width): what the accounting's bytes leg audits
        kv_item = 1 if self.kv_quant else torch.empty(
            (), dtype=dtype).element_size()
        self.pool_kv_bytes = (2 * num_layers * pool_pages * num_heads
                              * page_size * hd * kv_item)
        self.pool_scale_bytes = (2 * num_layers * pool_pages * num_heads * 4
                                 if self.kv_quant else 0)
        self.pool_bytes_per_device = (
            (self.pool_kv_bytes + self.pool_scale_bytes) // self.tp)
        # page 0 is the permanent DUMP page, never allocated: the step
        # runs every slot, and an idle slot's K/V write must land where
        # it can never belong to a live sequence — its table points at
        # page 0 with pos 0
        self.free_pages = set(range(1, pool_pages))
        self.pool_pages = pool_pages
        self.prefix_cache: Optional[PrefixPageCache] = (
            PrefixPageCache() if prefix_cache else None
        )
        # host MIRRORS of the decode loop state; the authoritative copies
        # live on the device and advance inside the step
        self.tables = np.zeros((slots, self.max_pages), np.int32)
        self.pos = np.zeros((slots,), np.int32)   # rows already consumed
        self._seqs = [_Seq() for _ in range(slots)]
        self._last = np.zeros((slots,), np.int32)
        self._tables_dev = torch.zeros((slots, self.max_pages),
                                       dtype=torch.int32, device=dev)
        self._pos_dev = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._last_dev = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._remaining_dev = torch.zeros((slots,), dtype=torch.int32,
                                          device=dev)
        # tokens emitted per slot, advanced by the step (the plain
        # step's key index), and the sampling state written at admission:
        # temperature (0 = greedy), base key and key-index offset
        self._counts_dev = torch.zeros((slots,), dtype=torch.int32,
                                       device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._base_keys = torch.zeros((slots, 2), dtype=torch.int64,
                                      device=dev)
        self._key_offsets = torch.zeros((slots,), dtype=torch.int32,
                                        device=dev)
        if speculate_k is not None:
            self._init_speculation(params, model_cfg, draft_params,
                                   draft_num_layers, draft_num_heads,
                                   draft_hidden)
        if dev.type == "cuda":
            # the step's attention operands keep this layout for the
            # batcher's life, so the kernel's checks run once here and
            # the step (or verify) passes checked=True
            if speculate_k is None:
                q = torch.empty((slots, num_heads, hd), dtype=dtype,
                                device=dev)
                check = check_kernel_args
            else:
                q = torch.empty((slots, speculate_k + 1, num_heads, hd),
                                dtype=dtype, device=dev)
                check = check_chunk_args
            for kent, vent in self.pools:
                kp, vp, ks, vs = pool_operands(kent, vent)
                check(q, kp, vp, self._tables_dev, self._pos_dev, ks, vs)
        self._inflight: deque = deque()
        # the prefill station: one persistent dense cache of
        # station_slots slots x prompt_pad rows; _jobs is insertion-
        # ordered (station slot -> job), so iterating it IS admission
        # order — the FIFO the chunk packer serves
        self._station = init_caches(station_slots, num_layers, num_heads,
                                    hidden, prompt_pad, dtype, dev)
        self._jobs: "OrderedDict[int, _PrefillJob]" = OrderedDict()
        # prefill-only serving: activations park instead of decoding, and
        # _sealed_pending announces each seal once (drain_sealed)
        self.prefill_only = bool(prefill_only)
        self._sealed_pending: List[int] = []
        # each queued entry carries its own prefix chain keys (computed
        # at submit), so a seq_id queued twice never aliases another
        # admission's hashes
        self._pending: deque = deque()
        self._reset_stats()
        self.attach_metrics(metrics)

    def _init_speculation(self, params, model_cfg, draft_params,
                          draft_num_layers: int, draft_num_heads: int,
                          draft_hidden: int) -> None:
        """The speculative half of the batcher: the verify twin of the
        target (shared weights, every window row's logits), the dense
        draft model at the ring's row count, the draft ring (a dense
        ``slots x draft_window`` cache) and its write head ``_d_pos``.
        When a slot's next verify window would spill past the ring, the
        draft restarts that slot's context at row 0: the accept rate
        dips, the target's stream cannot change (greedy verification is
        lossless for any draft)."""
        dev, ring = self.device, self.draft_window
        self.draft_num_layers = draft_num_layers
        self.draft_num_heads = draft_num_heads
        self.draft_hidden = draft_hidden
        self.verify_model = bind_params(
            PagedDecodeLM(max_seq=self.max_seq, all_logits=True,
                          **model_cfg),
            params,
        )
        dparams = head_f32(tree_map(lambda t: t.to(dev), draft_params))
        # the draft's position table is cut to the ring's rows
        dparams = dict(dparams, pos_embed={
            "embedding": dparams["pos_embed"]["embedding"][:ring]})
        self.draft_model = bind_params(
            DecodeLM(vocab_size=model_cfg["vocab_size"],
                     num_layers=draft_num_layers, num_heads=draft_num_heads,
                     hidden=draft_hidden, max_seq=ring,
                     dtype=self.dtype),
            dparams,
        )
        if self.kv_quant:
            # an int8 replica rests an int8 ring: (slots, ring, h, hd)
            # rows plus (slots, h) float32 per-(slot, head) scales
            d_hd = draft_hidden // draft_num_heads
            self.d_caches = [
                tuple((torch.zeros((self.slots, ring, draft_num_heads, d_hd),
                                   dtype=torch.int8, device=dev),
                       torch.zeros((self.slots, draft_num_heads),
                                   dtype=torch.float32, device=dev))
                      for _ in range(2))
                for _ in range(draft_num_layers)
            ]
        else:
            self.d_caches = init_caches(self.slots, draft_num_layers,
                                        draft_num_heads, draft_hidden, ring,
                                        self.dtype, dev)
        self._d_pos = np.zeros((self.slots,), np.int32)   # host mirror
        self._d_pos_dev = torch.zeros((self.slots,), dtype=torch.int32,
                                      device=dev)
        # the ring's resting bytes by storage dtype (serve_draft_ring_bytes)
        d_hd = draft_hidden // draft_num_heads
        ring_item = 1 if self.kv_quant else torch.empty(
            (), dtype=self.dtype).element_size()
        self.ring_kv_bytes = (2 * draft_num_layers * self.slots * ring
                              * draft_num_heads * d_hd * ring_item)
        self.ring_scale_bytes = (2 * draft_num_layers * self.slots
                                 * draft_num_heads * 4
                                 if self.kv_quant else 0)

    def attach_metrics(self, metrics) -> None:
        """Send the batcher's ``serve_*`` series to ``metrics`` (None
        stops them) — at construction, or after a warm-up whose requests
        the registry should not count.  Sets the construction-constant
        gauges once, off the step path: the pool's, and under
        speculation the draft ring's rows and resting bytes."""
        self.metrics = metrics
        if metrics is not None:
            metrics.set_gauge("serve_tp_devices", float(self.tp))
            metrics.set_gauge("serve_tp_pool_bytes_per_device",
                              float(self.pool_bytes_per_device))
            self._set_pool_bytes_gauges()
            if self.speculate_k is not None:
                metrics.set_gauge("serve_draft_cache_rows",
                                  float(self.slots * self.draft_window))
                self._set_draft_ring_bytes_gauges()

    def _set_pool_bytes_gauges(self) -> None:
        """Resting pool bytes by storage dtype: an int8 pool reports its
        int8 page bytes and its float32 scale bytes as two series, a
        full-width pool one series at its compute dtype."""
        if self.kv_quant:
            self.metrics.set_gauge("serve_pool_kv_bytes",
                                   float(self.pool_kv_bytes), dtype="int8")
            self.metrics.set_gauge("serve_pool_kv_bytes",
                                   float(self.pool_scale_bytes),
                                   dtype="float32")
        else:
            self.metrics.set_gauge("serve_pool_kv_bytes",
                                   float(self.pool_kv_bytes),
                                   dtype=self.kv_dtype)

    def _set_draft_ring_bytes_gauges(self) -> None:
        """Resting draft-ring bytes by storage dtype, as the pool's: an
        int8 ring reports its int8 row bytes and its float32 scale bytes,
        a full-width ring one series at its compute dtype."""
        if self.kv_quant:
            self.metrics.set_gauge("serve_draft_ring_bytes",
                                   float(self.ring_kv_bytes), dtype="int8")
            self.metrics.set_gauge("serve_draft_ring_bytes",
                                   float(self.ring_scale_bytes),
                                   dtype="float32")
        else:
            self.metrics.set_gauge("serve_draft_ring_bytes",
                                   float(self.ring_kv_bytes),
                                   dtype=self.kv_dtype)

    def _trace_holders(self):
        return self._seqs

    # -- page accounting ---------------------------------------------------
    def _pages_for(self, plen: int, max_new: int) -> int:
        # a verify window writes rows [pos, pos + k]; the last window
        # before retirement starts at plen + max_new - 2, so the
        # reservation carries k rows of write headroom: junk tail rows
        # land in pages this sequence owns, never a neighbour's
        extra = self.speculate_k or 0
        return -(-(plen + max_new + extra) // self.page)

    def _available_pages(self, reserved: Set[int]) -> int:
        """Pages obtainable right now: free + evictable cache entries,
        excluding ``reserved`` (hit pages this admission is about to
        acquire)."""
        idle = 0
        if self.prefix_cache is not None:
            idle = sum(
                1 for p in self.prefix_cache.pages()
                if self.prefix_cache.refcount(p) == 0 and p not in reserved
            )
        return len(self.free_pages) + idle

    def _alloc_page(self) -> int:
        """Pop a free page, evicting the LRU idle cache entry if the free
        list is empty.  Caller must have checked availability."""
        if self.free_pages:
            return self.free_pages.pop()
        page = self.prefix_cache.evict_lru()
        assert page is not None, "allocation past availability check"
        return page

    def _release_pages(self, s: _Seq) -> None:
        # indices below reclaimed_upto went back to the pool already
        # (reclaim_handoff_pages): releasing them twice would corrupt a
        # refcount or free a page twice
        for p in s.pages[s.reclaimed_upto:]:
            if p in s.shared:
                self.prefix_cache.release(p)
            else:
                self.free_pages.add(p)
        s.pages, s.shared = [], set()
        s.reclaimed_upto = 0

    def pages_in_use(self) -> int:
        """Distinct pool pages held by live sequences (shared pages count
        once); idle cache-resident pages are not in use."""
        idle = (
            self.prefix_cache.idle_count()
            if self.prefix_cache is not None else 0
        )
        return self.pool_pages - 1 - len(self.free_pages) - idle

    def assert_page_accounting(self) -> None:
        """Invariant check: every allocatable page is exactly one of free /
        cache-resident / privately live, refcounts equal the number of
        live sequences sharing each page, and the pool and station rest
        the declared dtype and bytes."""
        all_pages = set(range(1, self.pool_pages))
        cached = (
            self.prefix_cache.pages()
            if self.prefix_cache is not None else set()
        )
        private: Set[int] = set()
        refs: Dict[int, int] = {}
        for s in self._seqs:
            if s.seq_id < 0:
                continue
            # early-reclaimed handoff pages are back in the pool: the
            # slot no longer holds them, though ``pages`` keeps the index
            for p in s.pages[s.reclaimed_upto:]:
                if p in s.shared:
                    refs[p] = refs.get(p, 0) + 1
                else:
                    assert p not in private, f"page {p} doubly private"
                    private.add(p)
        assert not (self.free_pages & cached), "free page still cached"
        assert not (self.free_pages & private), "free page still live"
        assert not (private & cached), "private page in prefix cache"
        assert self.free_pages | cached | private == all_pages, (
            "page leak: "
            f"{sorted(all_pages - (self.free_pages | cached | private))}"
        )
        for p, n in refs.items():
            assert self.prefix_cache.refcount(p) == n, (
                f"page {p}: refcount {self.prefix_cache.refcount(p)} != "
                f"{n} live holders"
            )
        if self.prefix_cache is not None:
            for p in cached - set(refs):
                assert self.prefix_cache.refcount(p) == 0, (
                    f"page {p} refcounted with no live holder"
                )
            self.prefix_cache.assert_consistent()
            if not self._seal_decode:
                # with sealing off only the dense station registers
                # pages: nothing in the cache may claim decode numerics
                for p in cached:
                    assert self.prefix_cache.kind_of(p) == "prompt", (
                        f"page {p} sealed as decode with "
                        f"decode_page_cache={self.decode_page_cache!r}"
                    )
        # the bytes leg: the pool rests the declared storage format at
        # exactly the promised bytes (an int8 label over a full-width
        # allocation would pass every refcount check above)
        hd = self.hidden // self.num_heads
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        page_elems = self.num_heads * self.page * hd
        rest = 0
        for li, (kent, vent) in enumerate(self.pools):
            for nm, entry in (("k", kent), ("v", vent)):
                if self.kv_quant:
                    data, scale = entry
                    assert data.dtype == torch.int8, (
                        f"layer {li} {nm}_pool stores {data.dtype}, "
                        "declared kv_dtype int8")
                    assert scale.dtype == torch.float32, (
                        f"layer {li} {nm}_pool scales are {scale.dtype}")
                    assert tuple(scale.shape) == (self.pool_pages,
                                                  self.num_heads), (
                        f"layer {li} {nm}_pool scale shape drifted")
                    arrs = (data, scale)
                else:
                    assert entry.dtype == self.dtype, (
                        f"layer {li} {nm}_pool stores {entry.dtype}, "
                        f"declared kv_dtype {self.kv_dtype}")
                    arrs = (entry,)
                assert arrs[0].numel() == self.pool_pages * page_elems, (
                    f"layer {li} {nm}_pool rows drifted")
                rest += sum(a.numel() * a.element_size() for a in arrs)
        assert rest == self.pool_kv_bytes + self.pool_scale_bytes, (
            f"pool rests {rest} B, {self.kv_dtype} pages promise "
            f"{self.pool_kv_bytes + self.pool_scale_bytes}")
        st_bytes = self.station_slots * self.prompt_pad * self.num_heads * hd
        for li, (ck, cv) in enumerate(self._station):
            for nm, arr in (("k", ck), ("v", cv)):
                assert arr.dtype == self.dtype, (
                    f"station layer {li} {nm} stores {arr.dtype}"
                )
                assert arr.numel() == st_bytes, (
                    f"station layer {li} {nm} bytes drifted"
                )
        if self.speculate_k is not None:
            # the draft ring rests the pool's storage format (int8 rows
            # plus (slots, h) f32 scales, or the compute dtype) at
            # exactly slots x draft_window rows
            ring_elems = self.slots * self.draft_window * self.draft_hidden
            for li, (kent, vent) in enumerate(self.d_caches):
                for nm, entry in (("k", kent), ("v", vent)):
                    if self.kv_quant:
                        arr, scale = entry
                        assert arr.dtype == torch.int8, (
                            f"draft ring layer {li} {nm} stores "
                            f"{arr.dtype}, declared kv_dtype int8")
                        assert scale.dtype == torch.float32 and tuple(
                            scale.shape) == (self.slots,
                                             self.draft_num_heads), (
                            f"draft ring layer {li} {nm} scales drifted")
                    else:
                        arr = entry
                        assert arr.dtype == self.dtype, (
                            f"draft ring layer {li} {nm} stores {arr.dtype}"
                        )
                    assert arr.numel() == ring_elems, (
                        f"draft ring layer {li} {nm} rests {arr.numel()} "
                        f"elements, the ring promises {ring_elems}"
                    )

    # -- page moves between the station and the pool ------------------------
    def _write_pages(self, station: int, phys: List[int], base_row: int,
                     n_valid: int) -> None:
        """Scatter ``len(phys)`` consecutive station pages of slot
        ``station`` (rows ``base_row + j * page``) into pool pages
        ``phys[j]``: station rows are (row, h, hd), pool pages
        (h, page, hd).  An int8 pool quantizes each page at its tight
        per-head scale over the rows below ``n_valid`` only: station rows
        past the prompt still hold an earlier occupant's bytes, which
        would inflate the scale and make the page depend on station
        history, so they quantize to zeros."""
        n, page = len(phys), self.page
        idx = torch.tensor(phys, dtype=torch.long, device=self.device)
        rows = slice(base_row, base_row + n * page)
        if self.kv_quant:
            valid = (torch.arange(n * page, device=self.device) + base_row
                     < n_valid).view(n, 1, page, 1)
        for (kent, vent), (ck, cv) in zip(self.pools, self._station):
            for entry, cache in ((kent, ck), (vent, cv)):
                blk = cache[station, rows].view(
                    n, page, *cache.shape[2:]).transpose(1, 2)
                if self.kv_quant:
                    data, scale = entry
                    data[idx], scale[idx] = quantize_pages(
                        torch.where(valid, blk, 0))
                else:
                    entry[idx] = blk

    def _gather_pages(self, station: int, phys: List[int]) -> None:
        """The reverse copy: prefix-cache hit pages into station rows
        ``[0, len(phys) * page)`` — the same bytes, no recompute (an int8
        pool's pages dequantized to the compute dtype)."""
        n = len(phys) * self.page
        idx = torch.tensor(phys, dtype=torch.long, device=self.device)
        for (ck, cv), (kent, vent) in zip(self._station, self.pools):
            kp, vp, ks, vs = pool_operands(kent, vent)
            for cache, pool, scale in ((ck, kp, ks), (cv, vp, vs)):
                blk = pool[idx] if scale is None else dequantize_pages(
                    pool[idx], scale[idx], self.dtype)
                cache[station, :n] = blk.transpose(1, 2).reshape(
                    n, *cache.shape[2:])

    def _zero_page_scales(self, phys: List[int]) -> None:
        """Reset the scales of freshly allocated int8 pages.  A page off
        the free list (or evicted from the cache) still carries its
        previous occupant's scale, and grow-and-rescale only grows: left
        alone, a new sequence's first decode row would quantize at an
        inherited step, and the bytes would depend on allocation
        history.  A zero scale makes the first row write behave as on a
        fresh page."""
        if not self.kv_quant or not phys:
            return
        idx = torch.tensor(sorted(set(phys)), dtype=torch.long,
                           device=self.device)
        for (_, ks), (_, vs) in self.pools:
            ks[idx] = 0.0
            vs[idx] = 0.0

    def _seal_finished_pages(self, s: _Seq) -> None:
        """Retirement sealing: register a retiring sequence's complete
        pages, prompt and generated, in the prefix chain, so a later
        prompt extending its stream (a session's next turn) hits through
        the generated region.  Committed rows are ``plen + len(tokens) -
        1`` (the last emitted token is never consumed; speculative rows
        past the host-truncated stream are junk above the bound); only
        the full pages below that bound seal, under the submit-time chain
        keys of the whole stream.  An int8 pool first requantizes the
        pages to their tight scales: a rejected speculative row may have
        grown a scale that the committed rows never needed.  Policy-gated
        by ``decode_page_cache``."""
        if not self._seal_decode or s.plen == 0 or not s.tokens:
            return
        n_full = (s.plen + len(s.tokens) - 1) // self.page
        if n_full == 0:
            return
        n_prompt = (s.plen - 1) // self.page   # dense-prefill-only pages
        stream = np.concatenate([np.asarray(s.prompt, np.int32),
                                 np.asarray(s.tokens, np.int32)])
        keys = chain_keys(stream, self.page, n_full)
        to_seal = [(s.pages[j], keys[j], "prompt" if j < n_prompt else "decode",
                    keys[j - 1] if j else None)
                   for j in range(n_full)
                   if s.pages[j] not in s.shared
                   and self.prefix_cache.lookup(keys[j]) is None]
        if not to_seal:
            return
        if self.kv_quant:
            # the pages are private, so no reader sees the rewrite
            idx = torch.tensor([p for p, _, _, _ in to_seal],
                               dtype=torch.long, device=self.device)
            for kent, vent in self.pools:
                for data, scale in (kent, vent):
                    data[idx], scale[idx] = requantize_tight(data[idx],
                                                             scale[idx])
            self.stats["seal_requants"] += len(to_seal)
            if self.metrics is not None:
                self.metrics.inc("serve_kv_quant_seal_requants_total",
                                 len(to_seal))
        for phys, key, kind, prev in to_seal:
            self.prefix_cache.insert(key, phys, kind=kind, prev=prev)
            s.shared.add(phys)
            if kind == "decode":
                self.stats["decode_pages_sealed"] += 1
                if self.metrics is not None:
                    self.metrics.inc("serve_decode_pages_sealed_total")

    def prefix_cache_stats(self) -> dict:
        """The prefix-cache economy a replica exposes at ``/v1/state``:
        cached chains, resident pages by kind, and the hit/miss token
        counters split per ``prompt|decode`` kind."""
        if self.prefix_cache is None:
            chains, by_kind, idle = 0, {"prompt": 0, "decode": 0}, 0
        else:
            chains = self.prefix_cache.chains()
            by_kind = self.prefix_cache.pages_by_kind()
            idle = self.prefix_cache.idle_count()
        return {
            "chains": chains,
            "pages": by_kind,
            "idle_pages": idle,
            "hit_tokens": {
                "prompt": self.stats["prefix_hit_tokens_prompt"],
                "decode": self.stats["prefix_hit_tokens_decode"],
            },
            "miss_tokens": self.stats["prefix_miss_tokens"],
        }

    # -- admission ---------------------------------------------------------
    def _validate(self, prompt: np.ndarray, max_new: int) -> int:
        plen = validate_request(prompt, max_new, self.prompt_pad,
                                self.max_seq)
        if max_new > 0:
            if (
                self.speculate_k is not None
                and plen + max_new + self.speculate_k > self.max_seq
            ):
                raise ValueError(
                    f"prompt {plen} + max_new {max_new} + speculate_k "
                    f"{self.speculate_k} exceeds max_seq {self.max_seq}: "
                    "the speculative verify window needs k rows of cache "
                    "headroom"
                )
            need = self._pages_for(plen, max_new)
            if need > self.pool_pages - 1:  # page 0 is the dump page
                raise ValueError(
                    f"request needs {need} pages; the pool has "
                    f"{self.pool_pages - 1} allocatable"
                )
        return plen

    def _try_begin_admit(self, slot: int, seq_id: int, prompt: np.ndarray,
                         max_new: int, temperature: float,
                         submitted_at: float, keys: List[bytes],
                         seed: Optional[int]) -> bool:
        """Reserve pages (prefix-cache hits first), gather hit pages into
        a free station slot, and open the prefill job.  Returns False to
        defer (pool pressure, or an in-flight admission is prefilling
        this prompt's shared prefix) with no state changed."""
        plen = self._validate(prompt, max_new)
        s = self._seqs[slot]
        need = self._pages_for(plen, max_new)
        # sharable pages: FULL prompt pages strictly below row plen-1 —
        # the page holding the last prompt row takes the first decode
        # write, so it stays private
        hits: List[int] = []
        if self.prefix_cache is not None:
            for key in keys:  # the unbroken hit prefix
                page = self.prefix_cache.lookup(key)
                if page is None:
                    break
                hits.append(page)
            # if the first missed page is mid-prefill by another
            # admission, wait for it instead of computing it twice
            if len(hits) < len(keys):
                missed = keys[len(hits)]
                if any(missed in j.keys for j in self._jobs.values()):
                    return False
        if need - len(hits) > self._available_pages(set(hits)):
            return False  # defer until retirements/evictions free pages
        tr = self._traces.pop(seq_id, None)
        if tr is not None:
            # the queue phase ends at admission commit (pool and station
            # secured); gather and station residency get their own spans
            self._trace_phase_end(tr, "queue")
        station = min(set(range(self.station_slots)) - set(self._jobs))
        for j, key in enumerate(keys[: len(hits)]):
            acquired = self.prefix_cache.acquire(key)
            assert acquired == hits[j]
        fresh = [self._alloc_page() for _ in range(need - len(hits))]
        self._zero_page_scales(fresh)   # no inherited quantization state
        # the slot's table stays parked on the dump page until
        # activation: a prefilling slot's step writes must never land in
        # a real page — least of all a shared hit page
        s.seq_id, s.active, s.prefilling = seq_id, False, True
        s.gen += 1
        s.tokens, s.remaining = [], max_new
        s.pages, s.shared = hits + fresh, set(hits)
        s.submitted_at = submitted_at
        s.trace = tr
        hit_rows = len(hits) * self.page
        # hits split by the hit page's kind: station-sealed prompt pages
        # or retirement-sealed decode pages (a next turn reaching
        # through an earlier turn's output)
        decode_hit_rows = self.page * sum(
            1 for p in hits if self.prefix_cache.kind_of(p) == "decode")
        self.stats["prefix_hit_tokens"] += hit_rows
        self.stats["prefix_hit_tokens_prompt"] += hit_rows - decode_hit_rows
        self.stats["prefix_hit_tokens_decode"] += decode_hit_rows
        self.stats["prefix_miss_tokens"] += (len(keys) - len(hits)) * self.page
        self.stats["prompt_tokens"] += plen
        if self.metrics is not None:
            # kind-labeled only: an unlabeled sibling series would double
            # count every hit under a plain sum over the family
            prompt_hit_rows = hit_rows - decode_hit_rows
            if prompt_hit_rows:
                self.metrics.inc("serve_prefix_hit_tokens_total",
                                 prompt_hit_rows, kind="prompt")
            if decode_hit_rows:
                self.metrics.inc("serve_prefix_hit_tokens_total",
                                 decode_hit_rows, kind="decode")
            self.metrics.inc("serve_prompt_tokens_total", plen)
        # hit rows need station residency only if chunks run after them
        if hits and hit_rows < plen - 1:
            gspan = (tr.serve.child("prefix_gather", pages=len(hits),
                                    hit_rows=hit_rows)
                     if tr is not None else None)
            self._gather_pages(station, hits)
            if gspan is not None:
                gspan.end()
        if tr is not None:
            self._trace_phase_start(tr, "station_wait", hit_rows=hit_rows,
                                    pages=need)
        self._jobs[station] = _PrefillJob(
            slot=slot, station=station, seq_id=seq_id, prompt=prompt,
            plen=plen, keys=keys, pos=hit_rows, next_scatter=len(hits),
            temperature=temperature, seed=seed,
        )
        self.stats["admits"] += 1
        self.stats["peak_pages"] = max(
            self.stats["peak_pages"], self.pages_in_use()
        )
        return True

    # -- chunked prefill ---------------------------------------------------
    def _scatter_ready_pages(self, job: _PrefillJob) -> None:
        s = self._seqs[job.slot]
        # the ready run: pages prefill has passed, plus the partial tail
        # once the job is flushing (pos == plen - 1)
        first = hi = job.next_scatter
        while hi * self.page < job.pos:
            if (hi + 1) * self.page > job.pos and job.pos < job.plen - 1:
                break
            hi += 1
        if hi == first:
            return
        self._write_pages(job.station, s.pages[first:hi], first * self.page,
                          job.pos)
        for j in range(first, hi):
            if (
                self.prefix_cache is not None
                and j < len(job.keys)
                and (j + 1) * self.page <= job.pos
                and self.prefix_cache.lookup(job.keys[j]) is None
            ):
                self.prefix_cache.insert(
                    job.keys[j], s.pages[j], kind="prompt",
                    prev=job.keys[j - 1] if j else None)
                s.shared.add(s.pages[j])
        job.next_scatter = hi

    def _activate(self, job: _PrefillJob) -> None:
        # prompt rows [0, plen-1) are in pool pages; the LAST prompt
        # token rides the ordinary step (write row plen-1, attend
        # <= plen-1), which emits the first generated token
        slot, s = job.slot, self._seqs[job.slot]
        if job.seed is not None:
            # seed-pinned: the step's key index starts at plen, so each
            # key folds its token's absolute position — independent of
            # slot, batch composition and replica
            base_key, offset = prng.PRNGKey(job.seed), job.plen
        else:
            base_key, offset = prng.fold_in(self._root_key, job.seq_id), 0
        self._temps[slot] = job.temperature
        self._base_keys[slot] = base_key.to(self.device)
        self._key_offsets[slot] = offset
        self._counts_dev[slot] = 0
        s.temperature = float(job.temperature)
        s.base_key = tuple(int(w) for w in base_key.tolist())
        s.key_offset = offset
        # prefill-only serving: the prompt's pages just sealed with zero
        # tokens emitted; the slot parks (its device lane stays inactive)
        # and announces the seal, for an export from exactly this cursor
        # or a local unpark (set_prefill_only(False))
        park = self.prefill_only and s.remaining > 0
        self.tables[slot, :] = s.pages[0]
        self.tables[slot, : len(s.pages)] = s.pages
        self.pos[slot] = job.plen - 1
        last_tok = int(job.prompt[job.plen - 1])
        self._last[slot] = last_tok
        # push the slot's loop state to the device once, here; from now
        # until retirement the step advances it
        self._tables_dev[slot] = torch.from_numpy(self.tables[slot]).to(
            self.device
        )
        self._pos_dev[slot] = job.plen - 1
        self._last_dev[slot] = last_tok
        self._active_dev[slot] = not park
        self._remaining_dev[slot] = s.remaining
        # retirement sealing hashes the committed stream from its prompt
        s.prompt, s.plen = job.prompt[: job.plen], job.plen
        if self.speculate_k is not None:
            # the draft needs rows [0, plen - 1) of its ring before the
            # first window's scan consumes the last prompt token at row
            # plen - 1; that window also emits the first token
            self._draft_admit(slot, job.prompt[: job.plen])
            self._d_pos[slot] = job.plen - 1
            self._d_pos_dev[slot] = job.plen - 1
        s.prefilling, s.active = False, True
        if self.sampling and job.temperature > 0.0 and not park:
            # a sampled slot's first token is a direct target sample at
            # absolute position plen; its windows start at pos = plen
            self._spec_first_token(slot, s, base_key, job.plen)
        if park:
            s.parked = True
            self._sealed_pending.append(s.seq_id)
        tr = s.trace
        if tr is not None:
            t = time.monotonic()
            # full-prefix hits go straight station_wait -> decode (zero
            # chunks); everyone else closes the prefill phase here
            self._trace_phase_end(tr, "station_wait", t=t)
            self._trace_phase_end(tr, "prefill", t=t)
            self._trace_phase_start(tr, "decode", t=t)

    def _chunk(self, rows: torch.Tensor, starts: torch.Tensor,
               stations: List[int]) -> None:
        """One batched page-sized causal chunk across the picked station
        slots: slot ``stations[i]`` advances rows
        ``[starts[i], starts[i] + page)`` of its prompt, K/V landing at
        the same station rows; other station slots are untouched."""
        idx = torch.tensor(stations, dtype=torch.long, device=self.device)
        sub = [(ck[idx], cv[idx]) for ck, cv in self._station]
        self.dense_model.fill(rows, sub, starts)
        for (ck, cv), (sk, sv) in zip(self._station, sub):
            ck[idx] = sk
            cv[idx] = sv

    def _observe_prefill_wait(self, job: _PrefillJob) -> None:
        if self.metrics is not None:
            self.metrics.observe(
                "serve_prefill_wait_seconds",
                time.monotonic() - self._seqs[job.slot].submitted_at,
            )

    def _advance_prefill(self) -> None:
        """The token-budget step packer: rounds of one batched station
        chunk each, every round advancing each in-flight admission (FIFO
        order) one page, up to ``prefill_chunk`` rows per admission and
        ``token_budget`` rows (decode tokens included) per iteration."""
        self._last_prefill_rows = 0
        if self._jobs:
            if self.token_budget is None:
                pages_left = None
            else:
                # parked slots run no decode rows: their share of the
                # budget goes to prefill
                n_active = sum(1 for s in self._seqs
                               if s.active and not s.parked)
                if self.speculate_k is not None:
                    # a speculative slot's verify window is k+1 rows
                    n_active *= self.speculate_k + 1
                # at least one chunk always runs: a saturated decode
                # batch may taper prefill but never starve it
                pages_left = max(1, (self.token_budget - n_active) // self.page)
            advanced = {st: 0 for st in self._jobs}
            while True:
                picked = []
                for st, job in self._jobs.items():
                    if pages_left is not None and len(picked) >= pages_left:
                        break
                    if advanced[st] >= self._chunks_per_step:
                        continue
                    end = min(job.pos + self.page, job.plen - 1)
                    if end <= job.pos:
                        continue
                    picked.append((st, job, end))
                if not picked:
                    break
                rows = np.zeros((len(picked), self.page), np.int32)
                for i, (_, job, end) in enumerate(picked):
                    rows[i, : end - job.pos] = job.prompt[job.pos:end]
                starts = np.array([job.pos for _, job, _ in picked], np.int32)
                t0 = time.monotonic()
                self._chunk(
                    torch.from_numpy(rows).to(self.device),
                    torch.from_numpy(starts).to(self.device),
                    [st for st, _, _ in picked],
                )
                t1 = time.monotonic()
                for st, job, end in picked:
                    if not job.started:
                        job.started = True
                        self._observe_prefill_wait(job)
                    tr = self._seqs[job.slot].trace
                    if tr is not None:
                        if "prefill" not in tr.open:
                            self._trace_phase_end(tr, "station_wait", t=t0)
                            self._trace_phase_start(tr, "prefill", t=t0)
                        # chunk spans share the batched chunk's dispatch
                        # window: one call advanced every picked job
                        tr.open["prefill"].child(
                            "chunk", t=t0, rows_start=job.pos, rows_end=end,
                        ).end(t=t1)
                    self._last_prefill_rows += end - job.pos
                    job.pos = end
                    advanced[st] += 1
                    self.stats["prefill_chunks"] += 1
                    if self.metrics is not None:
                        self.metrics.inc("serve_prefill_chunks_total")
                    self._scatter_ready_pages(job)
                if pages_left is not None:
                    pages_left -= len(picked)
                    if pages_left <= 0:
                        break
        # completion pass: fully-prefilled prompts (including full-prefix
        # hits with zero chunks) flush their partial tails and activate
        done = [st for st, j in self._jobs.items() if j.pos >= j.plen - 1]
        for st in done:
            job = self._jobs.pop(st)
            if not job.started:
                job.started = True
                self._observe_prefill_wait(job)
            self._scatter_ready_pages(job)
            self._activate(job)

    # -- incremental serving API -------------------------------------------
    def submit(self, seq_id: int, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               session_id: Optional[str] = None,
               trace=None,
               seed: Optional[int] = None) -> None:
        """Queue one request.  Validates shape and worst-case pool limits
        eagerly (a request that can never fit fails here, not mid-loop)
        and computes its prefix chain keys.  ``temperature > 0`` samples;
        ``seed`` pins the sample stream to (seed, absolute token
        position), the same tokens on any replica, slot or batch.
        ``session_id`` is advisory: prefix sharing is content-addressed.
        ``trace`` is an optional caller span (the replica's request root,
        or a gateway's dispatch span): the request's ``serve`` subtree
        nests under it; otherwise the batcher's own ``tracer``, if any,
        roots one."""
        if seq_id < 0:
            raise ValueError(f"seq_id must be >= 0, got {seq_id}")
        if (self.speculate_k is not None and temperature > 0.0
                and not self.sampling):
            raise ValueError(
                "greedy-only speculative paged batcher: lossless "
                "speculative SAMPLING needs per-position rejection "
                "sampling against the target distribution — construct "
                "PagedContinuousBatcher with sampling=True (the verify "
                "then runs rejection_sample_block), or submit with "
                "temperature=0"
            )
        prompt = np.asarray(prompt, np.int32)
        plen = self._validate(prompt, max_new)
        keys: List[bytes] = []
        if self.prefix_cache is not None and max_new > 0:
            keys = chain_keys(prompt, self.page, (plen - 1) // self.page)
        self._trace_begin(seq_id, plen, max_new, trace)
        self._pending.append(
            (seq_id, prompt, max_new, temperature, time.monotonic(), keys,
             seed)
        )

    def cancel(self, seq_id: int) -> bool:
        """Withdraw a request from the queue, mid-prefill, or mid-decode;
        its pages go back to the pool (shared ones decref).  Returns
        False if the request is unknown."""
        for i, item in enumerate(self._pending):
            if item[0] == seq_id:
                del self._pending[i]
                self._trace_retire_queued(seq_id, "cancelled")
                return True
        for i, s in enumerate(self._seqs):
            if s.seq_id == seq_id:
                for st, job in list(self._jobs.items()):
                    if job.seq_id == seq_id:
                        # the station rows become garbage; the next job
                        # there overwrites them before it attends
                        del self._jobs[st]
                self._teardown_slot(i, s, reason="cancelled")
                s.active, s.prefilling = False, False
                s.tokens, s.remaining = [], 0
                return True
        return False

    def _teardown_slot(self, i: int, s: _Seq,
                       reason: str = "finished") -> None:
        """The shared retirement/cancel epilogue: close the request's
        trace (exactly one ``retire``), seal the complete pages (a
        policy-gated no-op unless the sequence committed tokens), release
        the rest and park the slot on the dump page, host mirror and
        device lane.  Sealing comes before release: it turns complete
        private pages cache-owned, so the release leaves them idle in the
        cache instead of freeing them."""
        self._trace_retire_slot(s, reason)
        self._seal_finished_pages(s)
        self._release_pages(s)
        if s.parked:
            # a parked sequence leaving before its seal was drained must
            # not announce a handoff of a dead cursor
            s.parked = False
            if s.seq_id in self._sealed_pending:
                self._sealed_pending.remove(s.seq_id)
        s.seq_id = -1
        s.prompt, s.plen = None, 0
        self.tables[i, :] = 0
        self.pos[i] = 0
        self._last[i] = 0
        # any still-in-flight step wrote only to this sequence's own
        # rows; every later one lands on the dump page
        self._tables_dev[i] = 0
        self._pos_dev[i] = 0
        self._last_dev[i] = 0
        self._active_dev[i] = False
        self._remaining_dev[i] = 0
        if self.speculate_k is not None:
            self._d_pos[i] = 0
            self._d_pos_dev[i] = 0

    def has_work(self) -> bool:
        return bool(self._pending) or any(s.seq_id >= 0 for s in self._seqs)

    # -- disaggregation verbs (prefill-only serving) -----------------------
    def drain_sealed(self) -> List[int]:
        """Seq ids whose prompts sealed (parked) since the last drain: the
        serving loop announces each once, and the gateway hands it off
        through ``export_pages``/``import_pages``."""
        out, self._sealed_pending = self._sealed_pending, []
        return out

    def set_prefill_only(self, flag: bool) -> bool:
        """Flip prefill-only serving live (the role actuator); returns
        whether the mode changed.  Turning it off unparks every parked
        slot into the step, except one whose handoff already reclaimed
        pages (``reclaimed_upto > 0``): its early pages left the pool, so
        it stays parked until its handoff completes or falls back through
        ``import_pages``.  Call it on the thread that steps the batcher."""
        flag = bool(flag)
        changed = flag != self.prefill_only
        self.prefill_only = flag
        if not flag:
            for i, s in enumerate(self._seqs):
                if s.seq_id >= 0 and s.parked and not s.reclaimed_upto:
                    s.parked = False
                    self._active_dev[i] = True
            self._sealed_pending = []
        return changed

    # -- live KV-page migration --------------------------------------------
    # Export is read-only: the exporter keeps its pages until the caller
    # detaches the sequence (``cancel``), so accounting holds on both
    # ends mid-transfer.  Import is atomic: every check runs before the
    # first refcount moves, so a refused import leaves pool, cache,
    # refcounts and device tensors as they were.  A payload's page bytes
    # are host numpy, read with one gather and one device-to-host copy,
    # written with one host-to-device copy and an ``index_copy_`` per
    # pool array, all on the batcher's stream.

    def _slot_of(self, seq_id: int) -> int:
        slot = next((i for i, s in enumerate(self._seqs)
                     if s.seq_id == seq_id), None)
        if slot is None:
            raise KeyError(f"unknown sequence {seq_id}")
        return slot

    def _transfer_geometry(self) -> dict:
        return {
            "page": self.page, "layers": self.num_layers,
            "heads": self.num_heads,
            "head_dim": self.hidden // self.num_heads,
            "dtype": _dtype_name(self.dtype),
            # schema 2: the pool's storage format rides the geometry, and
            # an int8 payload carries a "scales" section
            "kv_dtype": self.kv_dtype, "schema": 2, "tp": self.tp,
        }

    def _check_geometry(self, g: dict) -> None:
        want = self._transfer_geometry()
        got = dict(g)
        # schema-1 payloads stored full width at the compute dtype
        got.setdefault("kv_dtype", got.get("dtype"))
        for k in ("page", "layers", "heads", "head_dim", "dtype",
                  "kv_dtype"):
            if got.get(k) != want[k]:
                raise ValueError(
                    f"transfer geometry mismatch on {k}: payload "
                    f"{got.get(k)!r} vs this batcher {want[k]!r} — KV pages "
                    "move only between twins (same paged layout AND pool "
                    "storage format)"
                )

    def _export_layers(self, phys: List[int]):
        """Host copies of pool pages ``phys``: per-layer ``(k, v)`` arrays
        ``(n, heads, page, head_dim)``, plus their ``(n, heads)`` float32
        scales on an int8 pool (None at full width).  Every pool array is
        gathered into one staging tensor, which crosses to the host in one
        copy (an int8 pool's scales in a second)."""
        dev, n, L = self.device, len(phys), self.num_layers
        idx = torch.tensor(phys, dtype=torch.long, device=dev)
        shape = (L, 2, n, self.num_heads, self.page,
                 self.hidden // self.num_heads)
        if self.kv_quant:
            data = torch.empty(shape, dtype=torch.int8, device=dev)
            scale = torch.empty(shape[:4], dtype=torch.float32, device=dev)
            for li, (kent, vent) in enumerate(self.pools):
                for side, (d, sc) in enumerate((kent, vent)):
                    torch.index_select(d, 0, idx, out=data[li, side])
                    torch.index_select(sc, 0, idx, out=scale[li, side])
            return _host_pairs(data), _host_pairs(scale)
        buf = torch.empty(shape, dtype=self.dtype, device=dev)
        for li, (kp, vp) in enumerate(self.pools):
            torch.index_select(kp, 0, idx, out=buf[li, 0])
            torch.index_select(vp, 0, idx, out=buf[li, 1])
        return _host_pairs(buf), None

    def _check_page_arrays(self, layers, n_rows: int) -> None:
        hd = self.hidden // self.num_heads
        want = (n_rows, self.num_heads, self.page, hd)
        for k_np, v_np in layers:
            if (tuple(np.shape(k_np)) != want
                    or tuple(np.shape(v_np)) != want):
                raise ValueError(
                    f"malformed payload: page array shape "
                    f"{np.shape(k_np)} != {want}"
                )

    def _validate_scales(self, scales, n_pages: int) -> None:
        """Shape-check an int8 transfer's ``scales`` section, before any
        refcount moves."""
        sshape = (n_pages, self.num_heads)
        if not isinstance(scales, list) or len(scales) != self.num_layers:
            raise ValueError(
                "malformed payload: quantized transfer is missing "
                "its per-layer scales"
            )
        for ks_np, vs_np in scales:
            if (tuple(np.shape(ks_np)) != sshape
                    or tuple(np.shape(vs_np)) != sshape):
                raise ValueError(
                    f"malformed payload: scale array shape "
                    f"{np.shape(ks_np)} != {sshape}"
                )

    def _stage_imported(self, rows: List[int], layers, scales):
        """Rows ``rows`` of each transferred layer array (and scale array)
        as host tensors of the pool's storage dtype, stacked ``(layers,
        2, n, ...)``: the import's host side, run before its commit line,
        so a page array of the wrong type refuses the import
        (``ValueError``) with nothing changed."""
        sel = np.asarray(rows, np.intp)
        store = torch.int8 if self.kv_quant else self.dtype
        data = torch.stack([
            torch.stack([_host_tensor(np.asarray(a)[sel], store)
                         for a in pair])
            for pair in layers])
        if not self.kv_quant:
            return data, None
        scale = torch.stack([
            torch.stack([_host_tensor(np.asarray(a)[sel], torch.float32)
                         for a in pair])
            for pair in scales])
        return data, scale

    def _write_staged(self, staged, phys: List[int]) -> None:
        """Copy staged host pages to the device (one copy, two on an int8
        pool) and scatter them into pool pages ``phys``."""
        data, scale = staged
        idx = torch.tensor(phys, dtype=torch.long, device=self.device)
        data = data.to(self.device)
        if scale is None:
            for li, (kp, vp) in enumerate(self.pools):
                kp.index_copy_(0, idx, data[li, 0])
                vp.index_copy_(0, idx, data[li, 1])
            return
        scale = scale.to(self.device)
        for li, (kent, vent) in enumerate(self.pools):
            for side, (d, sc) in enumerate((kent, vent)):
                d.index_copy_(0, idx, data[li, side])
                sc.index_copy_(0, idx, scale[li, side])

    def export_pages(self, seq_id: int, cursor: int = 0) -> dict:
        """Serialize a live sequence for migration: its committed pages'
        K/V bytes, the chain keys and kinds that let the importer replay
        them into its prefix cache, and the decode cursor (tokens,
        remaining budget, sampling state).  Read-only: the caller
        detaches (``cancel``) once the importer acknowledged.  Drains the
        pipelined in-flight iteration first, so the payload holds every
        token the device committed.  ``cursor`` (streamed handoff): the
        first ``cursor`` pages went ahead as acked deltas, so the payload
        carries keys for every page but bytes only from page ``cursor``
        on (``layer_base``).  Raises ``KeyError`` for an unknown
        sequence and ``ValueError`` for one mid-prefill (nothing
        committed), already finished, or a cursor below its reclaim
        watermark."""
        slot = self._slot_of(seq_id)
        s = self._seqs[slot]
        if s.prefilling:
            raise ValueError(
                f"sequence {seq_id} is mid-prefill: nothing committed "
                "to move"
            )
        while self._inflight:
            self._process_entry(self._inflight.popleft())
        if not s.active:
            raise ValueError(
                f"sequence {seq_id} already finished: nothing to migrate"
            )
        committed = s.plen + len(s.tokens) - 1   # rows [0, committed)
        n_pages = -(-committed // self.page) if committed else 0
        n_full = committed // self.page
        n_prompt = (s.plen - 1) // self.page
        cursor = int(cursor)
        if cursor < 0 or cursor > n_pages:
            raise ValueError(
                f"export cursor {cursor} outside [0, {n_pages}]"
            )
        if cursor < s.reclaimed_upto:
            raise ValueError(
                f"export cursor {cursor} below reclaim watermark "
                f"{s.reclaimed_upto}: those pages left the pool"
            )
        stream = np.concatenate([np.asarray(s.prompt, np.int32),
                                 np.asarray(s.tokens, np.int32)])
        keys = chain_keys(stream, self.page, n_full)
        layers, scales = self._export_layers(s.pages[cursor:n_pages])
        self.stats["pages_exported"] += n_pages - cursor
        payload = {
            "kind": "live",
            "geometry": self._transfer_geometry(),
            "prompt": [int(t) for t in s.prompt],
            "tokens": list(s.tokens),
            "remaining": int(s.remaining),
            # the value the device holds: the float32 temperature
            "temperature": float(np.float32(s.temperature)),
            "base_key": list(s.base_key),
            "key_offset": int(s.key_offset),
            "page_keys": [keys[j].hex() if j < n_full else None
                          for j in range(n_pages)],
            "page_kinds": [("prompt" if j < n_prompt else "decode")
                           if j < n_full else None
                           for j in range(n_pages)],
            "layer_base": cursor,
            "layers": layers,
        }
        if scales is not None:
            payload["scales"] = scales
        if (self.speculate_k is not None and self.sampling
                and s.temperature > 0.0):
            # sampled speculation: the importer's accept draws compare
            # against the q this slot's ring produces, so a bit-identical
            # continuation ships the resting ring lane with the pages
            payload["draft"] = self._export_draft_ring(slot)
        return payload

    def _export_draft_ring(self, slot: int) -> dict:
        """The slot's whole draft-ring lane, ``(window, heads, head_dim)``
        rows per layer (plus ``(heads,)`` float32 scales on an int8
        ring).  Every row ships, not just [0, d_pos): an int8 ring's
        grow-only scale runs over the whole lane, junk rows included."""
        d = {
            "d_pos": int(self._d_pos[slot]),
            "window": int(self.draft_window),
            "layers": int(self.draft_num_layers),
            "heads": int(self.draft_num_heads),
            "head_dim": self.draft_hidden // self.draft_num_heads,
            "dtype": "int8" if self.kv_quant else _dtype_name(self.dtype),
        }
        if self.kv_quant:
            d["rows"] = _host_pairs(torch.stack([
                torch.stack([kd[slot], vd[slot]])
                for (kd, _), (vd, _) in self.d_caches]))
            d["scales"] = _host_pairs(torch.stack([
                torch.stack([ks[slot], vs[slot]])
                for (_, ks), (_, vs) in self.d_caches]))
        else:
            d["rows"] = _host_pairs(torch.stack([
                torch.stack([ck[slot], cv[slot]])
                for ck, cv in self.d_caches]))
        return d

    def _try_import_draft_ring(self, slot: int, draft) -> bool:
        """Splice an exported draft-ring lane into ``slot``.  Returns False,
        with nothing changed, when the section is absent or does not
        match this ring (the caller re-admits the prompt instead: safe,
        since rejection sampling is lossless in distribution for any
        draft, but not bit-stable).  It runs past the import's commit
        line, so it never raises."""
        if not isinstance(draft, dict):
            return False
        d_hd = self.draft_hidden // self.draft_num_heads
        want_dtype = "int8" if self.kv_quant else _dtype_name(self.dtype)
        if (draft.get("window") != self.draft_window
                or draft.get("layers") != self.draft_num_layers
                or draft.get("heads") != self.draft_num_heads
                or draft.get("head_dim") != d_hd
                or draft.get("dtype") != want_dtype):
            return False
        rows, scales = draft.get("rows"), draft.get("scales")
        row_shape = (self.draft_window, self.draft_num_heads, d_hd)

        def pairs_ok(pairs, shape) -> bool:
            return (isinstance(pairs, list)
                    and len(pairs) == self.draft_num_layers
                    and all(tuple(np.shape(a)) == shape
                            for pair in pairs for a in pair))

        if not pairs_ok(rows, row_shape) or (
                self.kv_quant
                and not pairs_ok(scales, (self.draft_num_heads,))):
            return False
        store = torch.int8 if self.kv_quant else self.dtype
        try:
            host_rows = [[_host_tensor(a, store) for a in pair]
                         for pair in rows]
            host_scales = ([[_host_tensor(a, torch.float32) for a in pair]
                            for pair in scales] if self.kv_quant else None)
        except ValueError:
            return False
        for li, (kent, vent) in enumerate(self.d_caches):
            for side, entry in enumerate((kent, vent)):
                if self.kv_quant:
                    entry[0][slot] = host_rows[li][side].to(self.device)
                    entry[1][slot] = host_scales[li][side].to(self.device)
                else:
                    entry[slot] = host_rows[li][side].to(self.device)
        return True

    def import_pages(self, seq_id: int, payload: dict,
                     trace=None) -> None:
        """The inverse verb: take pool pages for a migrated sequence,
        replay its prefix chain into the local cache (content addressing
        dedups against pages held here: a double import shares), write
        the transferred K/V and resume decode at the exported cursor.
        Atomic: slot, pool and payload are checked before the first
        refcount moves, so a refusal (``RuntimeError``) leaves this
        batcher as it was.  ``ValueError`` means the payload cannot be
        served here (geometry mismatch, seq_id in use, malformed).
        ``trace`` is the caller's span: the sequence opens a fresh
        ``serve`` subtree under it, marked ``imported``."""
        if payload.get("kind") != "live" or "geometry" not in payload:
            raise ValueError("not a live paged-KV payload")
        self._check_geometry(payload["geometry"])
        if seq_id < 0:
            raise ValueError(f"seq_id must be >= 0, got {seq_id}")
        if any(s.seq_id == seq_id for s in self._seqs) or any(
            item[0] == seq_id for item in self._pending
        ):
            raise ValueError(f"seq_id {seq_id} already in use")
        prompt = np.asarray(payload["prompt"], np.int32)
        tokens = [int(t) for t in payload["tokens"]]
        remaining = int(payload["remaining"])
        if remaining <= 0:
            raise ValueError("nothing left to decode")
        temperature = float(payload.get("temperature", 0.0))
        if (self.speculate_k is not None and temperature > 0.0
                and not self.sampling):
            raise ValueError(
                "greedy-only speculative paged batcher: importing a "
                "sampled sequence needs sampling=True"
            )
        base_key = [int(w) for w in (payload.get("base_key") or [0, 0])]
        if len(base_key) != 2 or not all(0 <= w < 2 ** 32 for w in base_key):
            raise ValueError(
                f"malformed payload: base_key {base_key} is not two "
                "uint32 words"
            )
        plen = self._validate(prompt, len(tokens) + remaining)
        committed = plen + len(tokens) - 1
        n_pages = -(-committed // self.page) if committed else 0
        page_keys = list(payload.get("page_keys") or [None] * n_pages)
        page_kinds = list(payload.get("page_kinds") or [None] * n_pages)
        layers = payload["layers"]
        # streamed handoff: the first layer_base pages went ahead as
        # acked deltas; keys for all pages, bytes from layer_base on
        layer_base = int(payload.get("layer_base") or 0)
        if layer_base < 0 or layer_base > n_pages:
            raise ValueError(
                f"malformed payload: layer_base {layer_base} outside "
                f"[0, {n_pages}]"
            )
        if (len(layers) != self.num_layers or len(page_keys) != n_pages
                or len(page_kinds) != n_pages):
            raise ValueError("malformed payload: layer/page counts drift")
        self._check_page_arrays(layers, n_pages - layer_base)
        scales = payload.get("scales")
        if self.kv_quant:
            self._validate_scales(scales, n_pages - layer_base)
        slot = next(
            (i for i, s in enumerate(self._seqs) if s.seq_id < 0), None
        )
        if slot is None:
            raise RuntimeError("import refused: no free sequence slot")
        need = self._pages_for(plen, len(tokens) + remaining)
        # every transferred key is probed on its own (no stop at the
        # first miss): LRU eviction can punch a hole in a cached chain,
        # and a cached later page must be shared, never inserted twice
        hits: Dict[int, int] = {}
        if self.prefix_cache is not None:
            for j in range(min(n_pages, need)):
                key = page_keys[j]
                if key is None:
                    continue
                page = self.prefix_cache.lookup(bytes.fromhex(key))
                if page is not None:
                    hits[j] = page
        # a page below layer_base has no bytes here: it must resolve from
        # the staged cache, or the import is refused (the handoff falls
        # back) before anything moves
        for j in range(min(layer_base, n_pages)):
            if j not in hits:
                raise RuntimeError(
                    f"import refused: page {j} below layer_base "
                    f"{layer_base} is neither staged here nor shipped "
                    "(delta evicted or never arrived)"
                )
        if need - len(hits) > self._available_pages(set(hits.values())):
            raise RuntimeError(
                f"import refused: needs {need - len(hits)} fresh pages, "
                f"{self._available_pages(set(hits.values()))} available"
            )
        to_write = [j for j in range(n_pages) if j not in hits]
        staged = (self._stage_imported([j - layer_base for j in to_write],
                                       layers, scales)
                  if to_write else None)
        # ---- commit: no failure path below this line ----
        # acquire every hit before the first allocation: _alloc_page
        # evicts idle entries, and a page this import shares must not be
        # the one evicted
        pages_by_j: Dict[int, int] = {}
        shared: Set[int] = set()
        for j, hit in hits.items():
            got = self.prefix_cache.acquire(bytes.fromhex(page_keys[j]))
            assert got == hit
            pages_by_j[j] = got
            shared.add(got)
        for j in range(need):
            if j not in pages_by_j:
                pages_by_j[j] = self._alloc_page()
        pages = [pages_by_j[j] for j in range(need)]
        # fresh pages start at scale 0; the transferred ones get their
        # real scales just below
        self._zero_page_scales([pages_by_j[j] for j in range(need)
                                if j not in hits])
        # replay the chain: transferred full pages register under their
        # keys (kind-gated as retirement sealing is), so the session's
        # next prompt hits here too
        if self.prefix_cache is not None:
            for j in to_write:
                key, kind = page_keys[j], page_kinds[j]
                if key is None or kind is None:
                    continue
                if kind == "decode" and not self._seal_decode:
                    continue
                if self.prefix_cache.lookup(bytes.fromhex(key)) is not None:
                    continue
                prev = page_keys[j - 1] if j else None
                self.prefix_cache.insert(
                    bytes.fromhex(key), pages[j], kind=kind,
                    prev=bytes.fromhex(prev) if prev else None,
                )
                shared.add(pages[j])
        if staged is not None:
            self._write_staged(staged, [pages[j] for j in to_write])
        # the cursor: the slot resumes where the exporter stopped
        s = self._seqs[slot]
        now = time.monotonic()
        s.seq_id, s.active, s.prefilling = seq_id, True, False
        # an imported sequence always decodes, on a prefill-only replica
        # too (the handoff's fallback resume)
        s.parked = False
        s.gen += 1
        s.tokens, s.remaining = list(tokens), remaining
        s.pages, s.shared = pages, shared
        s.submitted_at = now
        s.last_emit_at = now
        s.prompt, s.plen = prompt[:plen], plen
        s.temperature = temperature
        s.base_key = (base_key[0], base_key[1])
        s.key_offset = int(payload.get("key_offset", 0))
        last = tokens[-1] if tokens else int(prompt[plen - 1])
        self.tables[slot, :] = pages[0]
        self.tables[slot, : len(pages)] = pages
        self.pos[slot] = committed
        self._last[slot] = last
        # the loop state goes into the existing device tensors, in place;
        # counts resume at len(tokens), so with the exported offset the
        # key index stays the token's absolute position
        key_host = torch.tensor(base_key, dtype=torch.int64)
        self._temps[slot] = temperature
        self._base_keys[slot] = key_host.to(self.device)
        self._key_offsets[slot] = s.key_offset
        self._tables_dev[slot] = torch.from_numpy(self.tables[slot]).to(
            self.device)
        self._pos_dev[slot] = committed
        self._last_dev[slot] = last
        self._active_dev[slot] = True
        self._remaining_dev[slot] = remaining
        self._counts_dev[slot] = len(tokens)
        if self.speculate_k is not None:
            if (self.sampling and temperature > 0.0
                    and self._try_import_draft_ring(slot,
                                                    payload.get("draft"))):
                # the exporter's resting ring landed byte for byte: every
                # accept draw matches the un-migrated stream
                d_pos = int(payload["draft"]["d_pos"])
            else:
                # greedy (or no ring shipped): the ring is advisory; the
                # draft gets the prompt back and its head parks at the
                # real position (greedy verification is lossless for any
                # draft, so the stream cannot change)
                self._draft_admit(slot, prompt[:plen])
                d_pos = committed
            self._d_pos[slot] = d_pos
            self._d_pos_dev[slot] = d_pos
            if self.sampling and temperature > 0.0 and not tokens:
                # a post-prefill handoff (zero tokens): the importer owes
                # the first token, the direct sample at position plen
                self._spec_first_token(slot, s, key_host, plen)
        # a fresh serve subtree (the exporter's closed at detach), straight
        # to the decode phase
        self._trace_begin(seq_id, plen, len(tokens) + remaining, trace)
        tr = self._traces.pop(seq_id, None)
        if tr is not None:
            tr.serve.annotate(imported=True, pages=len(pages),
                              transferred=n_pages)
            self._trace_phase_end(tr, "queue")
            self._trace_phase_start(tr, "decode")
            s.trace = tr
        self.stats["imports"] += 1
        self.stats["admits"] += 1
        self.stats["pages_imported"] += len(to_write)
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pages_in_use())

    def export_sealed_chain(self, stream) -> Optional[dict]:
        """Serialize the sealed prefix-chain pages of a finished stream
        (prompt + generated tokens) out of the cache: the failover
        insurance verb.  Read-only.  Returns None when the cache holds
        nothing for the stream (the importer then prefills cold)."""
        if self.prefix_cache is None:
            return None
        stream = np.asarray(stream, np.int32)
        if stream.shape[0] < 2:
            return None
        n_full = (int(stream.shape[0]) - 1) // self.page  # sealing bound
        phys: List[int] = []
        page_keys: List[str] = []
        page_kinds: List[str] = []
        for key in chain_keys(stream, self.page, n_full):
            page = self.prefix_cache.lookup(key)
            if page is None:
                break   # chain hits are prefix-contiguous
            phys.append(page)
            page_keys.append(key.hex())
            page_kinds.append(self.prefix_cache.kind_of(page))
        if not phys:
            return None
        layers, scales = self._export_layers(phys)
        self.stats["pages_exported"] += len(phys)
        payload = {
            "kind": "sealed",
            "geometry": self._transfer_geometry(),
            "page_keys": page_keys,
            "page_kinds": page_kinds,
            "layers": layers,
        }
        if scales is not None:
            payload["scales"] = scales
        return payload

    def _check_chain_payload(self, payload: dict, kind: str):
        """The shared preamble of the sealed-chain and delta imports:
        kind, geometry, counts, page array and scale shapes."""
        if payload.get("kind") != kind or "geometry" not in payload:
            raise ValueError(f"not a {kind} paged-KV payload")
        self._check_geometry(payload["geometry"])
        page_keys = list(payload.get("page_keys") or [])
        page_kinds = list(payload.get("page_kinds")
                          or (["prompt"] * len(page_keys)
                              if kind == "delta" else []))
        layers = payload["layers"]
        if (len(layers) != self.num_layers
                or len(page_kinds) != len(page_keys)):
            raise ValueError("malformed payload: layer/page counts drift")
        self._check_page_arrays(layers, len(page_keys))
        scales = payload.get("scales")
        if self.kv_quant:
            self._validate_scales(scales, len(page_keys))
        return page_keys, page_kinds, layers, scales

    def import_sealed_chain(self, payload: dict) -> int:
        """Warm the prefix cache from a sealed-chain export: pages enter
        idle (refcount 0) under their chain keys, kind-gated as
        retirement sealing is, deduplicated against keys cached here.
        Imports the longest chain prefix the pool can hold, within a
        budget fixed at entry: pages imported here land idle and would
        count as available, so a live check would let the allocator evict
        this chain's own head.  Returns the number of pages imported."""
        page_keys, page_kinds, layers, scales = self._check_chain_payload(
            payload, "sealed")
        if self.prefix_cache is None:
            return 0
        budget = self._available_pages(set())
        plan: List[int] = []
        for j, keyhex in enumerate(page_keys):
            if self.prefix_cache.lookup(bytes.fromhex(keyhex)) is not None:
                continue             # already warm here
            if page_kinds[j] == "decode" and not self._seal_decode:
                break   # the policy gate: nothing past a skipped page hits
            if budget < 1:
                break   # partial warmth: the longest prefix that fits
            budget -= 1
            plan.append(j)
        staged = self._stage_imported(plan, layers, scales) if plan else None
        fresh: List[int] = []
        for j in plan:
            page = self._alloc_page()
            self.prefix_cache.insert(
                bytes.fromhex(page_keys[j]), page, kind=page_kinds[j],
                prev=bytes.fromhex(page_keys[j - 1]) if j else None,
            )
            self.prefix_cache.release(page)   # idle from birth
            fresh.append(page)
        if staged is not None:
            self._write_staged(staged, fresh)
        self.stats["pages_imported"] += len(fresh)
        return len(fresh)

    # -- streamed seal-time handoff ----------------------------------------
    # Chunked prefill seals sharable prompt pages one by one, so the pages
    # can ship while the later chunks compute.  Deltas are read-only on
    # the exporter; the importer stages them idle under their chain keys,
    # where the final cursor import claims them as prefix hits.  Once a
    # delta is acked, a parked exporter may release those pages early
    # (``reclaim_handoff_pages``).

    def export_sealed_delta(self, seq_id: int,
                            cursor: int) -> Optional[dict]:
        """The pages of ``seq_id``'s prompt chain sealed since page index
        ``cursor``, with their chain keys.  Works mid-prefill: the bound
        is the scattered sharable prefix, whose bytes are final.  Returns
        None when nothing new sealed; the payload's ``sealed`` flag says
        whether the sequence has parked (no later delta).  Raises
        ``KeyError`` for an unknown sequence, ``ValueError`` for one
        already decoding (``export_pages`` owns that phase)."""
        slot = self._slot_of(seq_id)
        s = self._seqs[slot]
        if s.prefilling:
            job = next((j for j in self._jobs.values()
                        if j.seq_id == seq_id), None)
            if job is None:
                return None
            sealed = min(job.next_scatter, len(job.keys))
            keys = job.keys
            parked = False
        elif s.parked:
            sealed = (s.plen - 1) // self.page
            keys = chain_keys(np.asarray(s.prompt, np.int32), self.page,
                              sealed)
            parked = True
        else:
            raise ValueError(
                f"sequence {seq_id} is decoding: use export_pages"
            )
        cursor = int(cursor)
        if cursor < 0 or cursor > sealed:
            raise ValueError(
                f"delta cursor {cursor} outside sealed bound {sealed}"
            )
        if cursor < s.reclaimed_upto:
            raise ValueError(
                f"delta cursor {cursor} below reclaim watermark "
                f"{s.reclaimed_upto}"
            )
        if cursor == sealed:
            return None
        layers, scales = self._export_layers(s.pages[cursor:sealed])
        self.stats["pages_exported"] += sealed - cursor
        payload = {
            "kind": "delta",
            "geometry": self._transfer_geometry(),
            "cursor": cursor,
            "page_keys": [k.hex() for k in keys[cursor:sealed]],
            "page_kinds": ["prompt"] * (sealed - cursor),
            "prev_key": keys[cursor - 1].hex() if cursor else None,
            "sealed": parked,
            "layers": layers,
        }
        if scales is not None:
            payload["scales"] = scales
        return payload

    def import_sealed_delta(self, payload: dict) -> int:
        """Stage one streamed-handoff delta in the prefix cache: each page
        enters idle under its chain key.  Atomic per delta: dedup and
        pool feasibility run before the first allocation, so a refusal
        (``RuntimeError``) stages nothing and leaves earlier deltas
        intact.  Returns the number of pages newly staged."""
        page_keys, page_kinds, layers, scales = self._check_chain_payload(
            payload, "delta")
        if self.prefix_cache is None:
            raise RuntimeError(
                "delta import refused: no prefix cache to stage into"
            )
        prev_hex = payload.get("prev_key")
        # staged pages enter most recent in the LRU, so this call's
        # allocations never evict a page it staged; an earlier delta's
        # idle pages may go under pressure, and the final import then
        # refuses (a layer_base hole) and the handoff falls back
        fresh = [j for j, keyhex in enumerate(page_keys)
                 if self.prefix_cache.lookup(bytes.fromhex(keyhex)) is None]
        if len(fresh) > self._available_pages(set()):
            raise RuntimeError(
                f"delta import refused: needs {len(fresh)} pages, "
                f"{self._available_pages(set())} available"
            )
        staged = (self._stage_imported(fresh, layers, scales)
                  if fresh else None)
        pages: List[int] = []
        for j in fresh:
            page = self._alloc_page()
            prev = page_keys[j - 1] if j else prev_hex
            self.prefix_cache.insert(
                bytes.fromhex(page_keys[j]), page, kind=page_kinds[j],
                prev=bytes.fromhex(prev) if prev else None,
            )
            self.prefix_cache.release(page)   # staged idle
            pages.append(page)
        if staged is not None:
            self._write_staged(staged, pages)
        self.stats["pages_imported"] += len(pages)
        return len(pages)

    def reclaim_handoff_pages(self, seq_id: int, upto: int) -> int:
        """Release ``seq_id``'s first ``upto`` pages to the pool once the
        importer acked the deltas holding them.  Only a parked sequence
        sheds pages: a prefilling one still attends over them and a
        decoding one writes new rows.  Shared pages decref to idle (still
        found by chain key, for the fallback re-import); private ones
        free.  Raises ``KeyError`` for an unknown sequence; returns the
        pages freed (0 when not parked)."""
        slot = self._slot_of(seq_id)
        s = self._seqs[slot]
        if not s.parked:
            return 0
        upto = min(int(upto), (s.plen - 1) // self.page)
        freed = 0
        for p in s.pages[s.reclaimed_upto:upto]:
            if p in s.shared:
                self.prefix_cache.release(p)
                s.shared.discard(p)
            else:
                self.free_pages.add(p)
            freed += 1
        s.reclaimed_upto = max(s.reclaimed_upto, upto)
        if freed:
            self.stats["pages_reclaimed"] += freed
            if self.metrics is not None:
                self.metrics.inc("serve_handoff_pages_reclaimed_total",
                                 freed)
        return freed

    def live_tokens(self) -> Dict[int, List[int]]:
        """Committed tokens of every live sequence (under the pipelined
        loop, each delta is a step the device can no longer change)."""
        return {s.seq_id: list(s.tokens) for s in self._seqs if s.seq_id >= 0}

    def _reset_stats(self) -> None:
        self.stats = {
            "steps": 0, "admits": 0, "peak_pages": 0, "prefill_chunks": 0,
            "prefix_hit_tokens": 0, "prefix_hit_tokens_prompt": 0,
            "prefix_hit_tokens_decode": 0, "prefix_miss_tokens": 0,
            "prompt_tokens": 0, "decode_pages_sealed": 0,
            "seal_requants": 0, "spec_steps": 0, "spec_tokens": 0,
            "draft_wraps": 0, "pages_exported": 0, "pages_imported": 0,
            "imports": 0, "pages_reclaimed": 0,
        }
        # seq_id -> seconds from submit to the first token's readback
        self.first_token_s: Dict[int, float] = {}

    def _sweep(self, finished: Dict[int, List[int]]) -> None:
        progress = True
        while progress:
            progress = False
            for i, s in enumerate(self._seqs):
                if s.seq_id >= 0 and not s.active and not s.prefilling:
                    finished[s.seq_id] = s.tokens
                    self._teardown_slot(i, s)
                    progress = True
            # admission is strictly FIFO: a head that cannot begin holds
            # everything behind it in place
            while self._pending:
                nxt = self._pending[0]
                free = next(
                    (i for i, s in enumerate(self._seqs) if s.seq_id < 0),
                    None,
                )
                if free is None:
                    break
                if nxt[2] <= 0:
                    # zero-budget no-op admit: no pages, no station work
                    s = self._seqs[free]
                    s.seq_id, s.active = nxt[0], False
                    s.gen += 1
                    s.prefilling, s.tokens, s.remaining = False, [], 0
                    s.trace = self._traces.pop(nxt[0], None)
                    self._pending.popleft()
                    self.stats["admits"] += 1
                    progress = True
                    continue
                if len(self._jobs) >= self.station_slots:
                    break  # every station slot busy: wait, in order
                if not self._try_begin_admit(free, *nxt):
                    break  # head deferred: hold the FIFO line
                self._pending.popleft()
                progress = True

    @torch.no_grad()
    def serve_step(self) -> Dict[int, List[int]]:
        """One serving iteration: retire + admit, advance every in-flight
        admission, dispatch one decode step if anything is active, then
        read tokens at the one readback point — one step late when
        ``pipeline_decode`` is on.  A slot awaiting its FIRST token reads
        back at once, so time to first token keeps synchronous
        semantics.  The iteration's ledger row is recorded last."""
        t_begin = time.monotonic()
        self._sync_wait_s = 0.0
        finished: Dict[int, List[int]] = {}
        spec_emitted = 0
        self._sweep(finished)
        self._advance_prefill()
        if self.metrics is not None:
            self.metrics.set_gauge("serve_station_slots_busy",
                                   float(len(self._jobs)))
        n_active = sum(1 for s in self._seqs if s.active and not s.parked)
        if n_active:
            if self.speculate_k is not None:
                self._dispatch_spec()
            else:
                self._dispatch_step()
        keep = 1 if (
            self.pipeline_decode
            and n_active
            and not any(s.active and not s.parked and not s.tokens
                        for s in self._seqs)
        ) else 0
        while len(self._inflight) > keep:
            spec_emitted += self._process_entry(self._inflight.popleft())
        if n_active:
            self._sweep(finished)
            if not any(s.seq_id >= 0 for s in self._seqs):
                # every sequence retired: the overhang step is all junk
                while self._inflight:
                    spec_emitted += self._process_entry(
                        self._inflight.popleft())
        host_s = (time.monotonic() - t_begin) - self._sync_wait_s
        self._ledger_record(n_active, spec_emitted, host_s,
                            self._sync_wait_s)
        return finished

    def _loop_state(self):
        """The step's input state — last tokens, tables, positions,
        active mask, budgets, emitted counts and (speculation) the draft
        ring's write heads: the previous step's device outputs
        (pipelined), or the host mirrors uploaded anew (synchronous)."""
        if self.pipeline_decode:
            return (self._last_dev, self._tables_dev, self._pos_dev,
                    self._active_dev, self._remaining_dev, self._counts_dev,
                    self._d_pos_dev if self.speculate_k is not None
                    else None)
        active = np.array([s.active and not s.parked for s in self._seqs],
                          bool)
        remaining = np.array([s.remaining for s in self._seqs], np.int32)
        counts = np.array([len(s.tokens) for s in self._seqs], np.int32)
        state = [torch.tensor(a, device=self.device) for a in
                 (self._last, self.tables, self.pos, active, remaining,
                  counts)]
        d_pos = (torch.tensor(self._d_pos, device=self.device)
                 if self.speculate_k is not None else None)
        return (*state, d_pos)

    def _samples(self) -> bool:
        """Whether a live slot samples: the host knows every slot's
        temperature from its admission, so an all-greedy iteration skips
        the draws (their rows would take the argmax anyway) without
        reading the device's sampling state."""
        return any(s.active and not s.parked and s.temperature > 0.0
                   for s in self._seqs)

    def _step(self, last, table, pos, active, remaining, counts,
              sampled: bool):
        """The whole loop transition: emit a token for every slot, then
        advance last/pos/counts and retire (budget/EOS) active slots on
        the device.  A sampled iteration draws each slot's token with the
        key ``fold_in(base, count + offset)``.  Inactive lanes are parked
        on the dump page here, so their K/V write lands on page 0 however
        late the host learns of a retirement."""
        table = torch.where(active[:, None], table, 0)
        run_pos = torch.where(active, pos, 0)
        logits = self.model(last[:, None], self.pools, table, run_pos,
                            checked=True)
        if sampled:
            keys = prng.fold_in(self._base_keys, counts + self._key_offsets)
            toks = pick_tokens(logits, self._temps, keys, self.top_k)
        else:
            toks = logits.argmax(-1).to(torch.int32)
        act = active.to(torch.int32)
        new_rem = remaining - act
        done = new_rem <= 0
        if self.eos_id is not None:
            done = done | (toks == self.eos_id)
        new_active = active & ~done
        new_last = torch.where(active, toks, last)
        return (toks, new_last, pos + act, new_active, new_rem,
                counts + act)

    def _dispatch_step(self) -> None:
        """Launch one decode step on the device state and start its
        token readback; the host reads it in ``_process_entry``."""
        cand = {i: s.gen for i, s in enumerate(self._seqs)
                if s.active and not s.parked}
        last, table, pos, active, remaining, counts, _ = self._loop_state()
        (toks, self._last_dev, self._pos_dev, self._active_dev,
         self._remaining_dev, self._counts_dev) = self._step(
            last, table, pos, active, remaining, counts, self._samples())
        self.stats["steps"] += 1
        self._inflight.append(_Inflight(cand, *self._read_back(toks)))

    @staticmethod
    def _read_back(result: torch.Tensor):
        """Start the one readback of a dispatched iteration: on the card a
        ``non_blocking`` copy into pinned host memory plus an event, so
        the host can enqueue the next iteration before it waits."""
        if not result.is_cuda:
            return result, None
        host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
        host.copy_(result, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # -- speculative decoding (greedy) ---------------------------------------
    def _draft_admit(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill the prompt, padded to ``prompt_pad``, into the slot's
        whole ring lane, zeros past it: a reused slot's stale rows go
        wholesale.  Padding junk past the prompt is overwritten by the
        draft scan's contiguous writes before any causal mask exposes
        it.  The draft always recomputes the full prompt: prefix-cache
        hits skip target pages only.  A sampling batcher then re-applies
        the last prompt token as a one-token forward (row plen - 1
        rewritten at the step's shapes), as the JAX batcher does: the
        rejection sampler compares the draft's q bit for bit."""
        row = np.zeros((1, self.prompt_pad), np.int32)
        row[0, : len(prompt)] = prompt
        tokens = torch.from_numpy(row).to(self.device)

        def fill(lane):
            self.draft_model.fill(tokens, lane, 0)
            if self.sampling:
                plen = len(prompt)
                self.draft_model.fill(tokens[:, plen - 1: plen], lane,
                                      plen - 1)

        if self.kv_quant:
            # an int8 ring: prefill a fresh full-width lane, then splice it
            # in at its own tight scale
            fresh = init_caches(1, self.draft_num_layers,
                                self.draft_num_heads, self.draft_hidden,
                                self.draft_window, self.dtype, self.device)
            fill(fresh)
            for (kent, vent), (fk, fv) in zip(self.d_caches, fresh):
                for (data, scale), full in ((kent, fk), (vent, fv)):
                    data[slot: slot + 1], scale[slot: slot + 1] = (
                        quantize_ring(full))
            return
        lane = [(ck[slot: slot + 1], cv[slot: slot + 1])
                for ck, cv in self.d_caches]
        for ck, cv in lane:
            ck.zero_()
            cv.zero_()
        fill(lane)

    def _spec_first_token(self, slot: int, s: _Seq, base_key,
                          plen: int) -> None:
        """A sampled speculative admission's first token, as the JAX
        batcher draws it: the plain model consumes the last prompt token
        at row plen - 1 (the row the first window would write) and the
        token is a direct target sample at absolute position plen under
        the SAMPLE tag, so the request's draft, accept and resample keys
        from plen + 1 on line up with the dense reference.  One b = 1
        forward (K1 on the card) per sampled admission, read back at
        once."""
        key = position_key(base_key, plen, KEY_TAG_SAMPLE).to(self.device)
        logits = self.model(self._last_dev[slot: slot + 1, None], self.pools,
                            self._tables_dev[slot: slot + 1],
                            self._pos_dev[slot: slot + 1])
        tok = int(pick_tokens(logits, self._temps[slot: slot + 1],
                              key[None], self.top_k)[0])
        s.tokens = [tok]
        s.remaining -= 1
        # the device lane sees the first token's budget debit too, or its
        # budget truncation would retire one window late
        self._remaining_dev[slot] = max(s.remaining, 0)
        self.pos[slot] = plen
        self._last[slot] = tok
        self._pos_dev[slot] = plen
        self._last_dev[slot] = tok
        self._counts_dev[slot] = 1
        self._d_pos[slot] = plen
        self._d_pos_dev[slot] = plen
        _observe_emit(self.metrics, s, first=True)
        self.first_token_s[s.seq_id] = s.last_emit_at - s.submitted_at
        self._trace_first_token(s)
        if s.remaining <= 0 or (self.eos_id is not None
                                and tok == self.eos_id):
            # finished at admission: retire the device lane now; the next
            # sweep reaps the slot
            s.active = False
            self._active_dev[slot] = False
            self._remaining_dev[slot] = 0

    def _spec_draft(self, last, d_pos, active, noise=None):
        """Draft k proposals per slot: k+1 steps of the dense draft over
        its ring, the extra step's proposal discarded but its ring write
        load-bearing (it consumes p_k, so row d_pos + k is no hole after
        a fully accepted window).  Steps are greedy, or with ``noise``
        (b, k+1, vocab), the gumbel noise of the window's draft keys,
        sampled rows draw their proposals and the step logits come back
        for the verify's rejection sampler.  A slot whose window would
        spill past the ring wraps to row 0 here; the flags come back so
        the host mirror can replay the wrap."""
        k = self.speculate_k
        wrap = active & (d_pos + (k + 1) > self.draft_window)
        d_pos_w = torch.where(wrap, 0, d_pos)
        # inactive lanes scan from row 0 of their own (idle) ring lane:
        # a row index past the ring would raise
        p = torch.where(active, d_pos_w, 0)
        # an int8 ring is dequantized whole for the scan and requantized
        # whole after it (grow-and-rescale per slot and head)
        caches = self.d_caches if not self.kv_quant else [
            tuple((d.float() * sc[:, None, :, None]).to(self.dtype)
                  for d, sc in (ke, ve))
            for ke, ve in self.d_caches]
        tok, proposed, d_logits = last, [], []
        for j in range(k + 1):
            logits = self.draft_model(tok[:, None], caches, p)
            if noise is None:
                tok = logits.argmax(-1).to(torch.int32)
            else:
                tok = pick_with_noise(logits, self._temps, noise[:, j],
                                      self.top_k)
                d_logits.append(logits)
            proposed.append(tok)
            p = p + 1
        if self.kv_quant:
            for (kent, vent), (fk, fv) in zip(self.d_caches, caches):
                for (data, scale), full in ((kent, fk), (vent, fv)):
                    q, new_s = quantize_ring(full, scale)
                    data.copy_(q)
                    scale.copy_(new_s)
        d_logits = torch.stack(d_logits[:k], 1) if d_logits else None
        return torch.stack(proposed[:k], 1), d_pos_w, wrap, d_logits

    def _spec_verify(self, last, proposals, table, pos, d_pos, active,
                     remaining, sampled_in=None):
        """Score the window ``[last, p_1..p_k]`` of every slot in one
        paged forward (K2), accept the longest prefix matching the
        target's greedy choices, and commit on the device: cap at the
        slot's budget, cut at the first EOS, retire on either, advance
        pos and d_pos by the rows the window consumed.  With
        ``sampled_in`` (the draft's logits and the window's accept and
        resample keys) sampled rows take the rejection sampler's block
        and accept count instead.  Inactive lanes are parked on the dump
        page (table 0, pos 0): a retired slot's overhang window would
        otherwise write past its reservation, where the table's padding
        points at its first page — which may be sealed in the prefix
        cache."""
        k = self.speculate_k
        slots = torch.arange(last.shape[0], device=last.device)
        table = torch.where(active[:, None], table, 0)
        run_pos = torch.where(active, pos, 0)
        window = torch.cat([last[:, None], proposals], 1)
        logits = self.verify_model(window, self.pools, table, run_pos,
                                   checked=True)
        choices = logits.argmax(-1).to(torch.int32)        # (b, k + 1)
        match = proposals == choices[:, :k]
        # accepted proposals: the first mismatch (k if all match)
        accepted = torch.cat(
            [match, torch.zeros_like(match[:, :1])], 1
        ).to(torch.int32).argmin(1).to(torch.int32)
        if sampled_in is not None:
            d_logits, a_keys, s_keys = sampled_in
            choices, accepted = sampled_verify(
                logits, d_logits, proposals, choices, accepted, self._temps,
                a_keys, s_keys, self.top_k)
        emit_len = accepted + 1
        next_last = choices[slots, accepted.long()]
        act = active.to(torch.int32)
        trunc = torch.minimum(emit_len, remaining)
        if self.eos_id is not None:
            cols = torch.arange(k + 1, device=last.device)
            iseos = (choices == self.eos_id) & (cols[None, :] < trunc[:, None])
            has_eos = iseos.any(1)
            n_emit = torch.where(
                has_eos, iseos.to(torch.int32).argmax(1).to(torch.int32) + 1,
                trunc,
            )
        else:
            has_eos = torch.zeros_like(active)
            n_emit = trunc
        new_rem = remaining - n_emit * act
        done = (new_rem <= 0) | has_eos
        return (choices, emit_len, torch.where(active, next_last, last),
                pos + emit_len * act, d_pos + emit_len * act,
                active & ~done, new_rem)

    def _dispatch_spec(self) -> None:
        """Launch one speculative iteration (draft scan, then the fused
        verify), chaining device state exactly like ``_dispatch_step``;
        its choices, emitted lengths and wrap flags come back packed in
        one int32 tensor, the iteration's only readback."""
        cand = {i: s.gen for i, s in enumerate(self._seqs)
                if s.active and not s.parked}
        last, table, pos, active, remaining, _, d_pos = self._loop_state()
        sampled = self.sampling and self._samples()
        if self.metrics is not None:
            draft_ctx = self.metrics.timer("serve_spec_draft_seconds")
            verify_ctx = self.metrics.timer("serve_spec_verify_seconds")
        else:
            draft_ctx = verify_ctx = nullcontext()
        # pipelined, the timers measure dispatch windows; synchronous,
        # each is fenced so it holds its own program's device time
        fence = (self.metrics is not None and not self.pipeline_decode
                 and self.stream is not None)
        td0 = time.monotonic()
        with draft_ctx:
            noise = None
            if sampled:
                # the window's keys fold the absolute positions pos + 1 ..
                # (the committed-row cursor, which survives ring wraps);
                # the draft's noise is drawn for all k + 1 steps at once
                d_keys, a_keys, s_keys = window_keys(
                    self._base_keys, pos, self.speculate_k)
                noise = prng.gumbel(d_keys, self.model.vocab_size)
            proposals, d_pos_w, wrapped, d_logits = self._spec_draft(
                last, d_pos, active, noise)
            if fence:
                self.stream.synchronize()
        tv0 = time.monotonic()
        with verify_ctx:
            (choices, emit_len, self._last_dev, self._pos_dev,
             self._d_pos_dev, self._active_dev,
             self._remaining_dev) = self._spec_verify(
                last, proposals, table, pos, d_pos_w, active, remaining,
                (d_logits, a_keys, s_keys) if sampled else None)
            if fence:
                self.stream.synchronize()
        tv1 = time.monotonic()
        packed = torch.cat([choices, emit_len[:, None],
                            wrapped.to(torch.int32)[:, None]], 1)
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        self._inflight.append(_Inflight(cand, *self._read_back(packed),
                                        td0=td0, tv0=tv0, tv1=tv1))

    def _process_entry(self, entry: _Inflight) -> int:
        """The one readback point: wait for a dispatched iteration's
        results and replay its integer arithmetic on the host mirrors —
        token append, budget/EOS retirement (and, speculating, the
        ring wrap and the window's truncation), tracing and metrics.
        Lanes whose slot changed occupant since dispatch are junk and
        dropped.  The wait counts as the iteration's ``device_ms``.
        Returns the tokens a speculative iteration committed."""
        t0 = time.monotonic()
        if entry.event is not None:
            entry.event.synchronize()
        toks_h = entry.toks.numpy()
        self._sync_wait_s += time.monotonic() - t0
        k = self.speculate_k
        spec_emitted = 0
        for i, s in enumerate(self._seqs):
            gen = entry.cand.get(i)
            if gen is None or s.gen != gen or not s.active:
                continue
            if k is None:
                self.pos[i] += 1  # the step consumed one row
                emitted = [int(toks_h[i])]
                self._last[i] = emitted[0]
            else:
                if toks_h[i, k + 2]:
                    # the draft restarted this slot's ring context
                    self._d_pos[i] = 0
                    self.stats["draft_wraps"] += 1
                # the window consumed e rows: [pos, pos + e) now hold the
                # committed continuation's K/V; rejected rows above are
                # junk the next window overwrites
                e = int(toks_h[i, k + 1])
                self.pos[i] += e
                self._d_pos[i] += e
                self._last[i] = int(toks_h[i, e - 1])
                # the window may run past the budget or an EOS: the
                # surplus is junk
                emitted = [int(t) for t in toks_h[i, :e]][: s.remaining]
                if self.eos_id is not None and self.eos_id in emitted:
                    emitted = emitted[: emitted.index(self.eos_id) + 1]
                spec_emitted += len(emitted)
                tr = s.trace
                if tr is not None and "decode" in tr.open:
                    # one draft and one verify span per iteration per
                    # traced slot, sharing the iteration's dispatch
                    # windows (one draft scan and one verify covered
                    # every slot)
                    decode = tr.open["decode"]
                    decode.child("spec_draft", t=entry.td0, k=k).end(
                        t=entry.tv0)
                    decode.child("spec_verify", t=entry.tv0, accepted=e,
                                 emitted=len(emitted)).end(t=entry.tv1)
                if self.metrics is not None:
                    self.metrics.observe(
                        "serve_spec_accept_rate", (e - 1) / k,
                        mode="sampled" if s.temperature > 0.0 else "greedy")
            for t in emitted:
                first = not s.tokens
                s.tokens.append(t)
                _observe_emit(self.metrics, s, first=first)
                if first:
                    self.first_token_s[s.seq_id] = (s.last_emit_at
                                                    - s.submitted_at)
                    self._trace_first_token(s)
            s.remaining -= len(emitted)
            if s.remaining <= 0 or (
                self.eos_id is not None and emitted[-1] == self.eos_id
            ):
                s.active = False
        if k is not None:
            self.stats["spec_tokens"] += spec_emitted
            if self.metrics is not None:
                # tokens_per_step / steps_total is the mean multi-token
                # yield per verify
                self.metrics.inc("serve_spec_tokens_per_step", spec_emitted)
                self.metrics.inc("serve_spec_steps_total")
        return spec_emitted

    # -- the step ledger -----------------------------------------------------
    def _ledger_record(self, n_active: int, spec_emitted: int,
                       host_s: float = 0.0, device_s: float = 0.0) -> None:
        """Append this iteration's row to the bounded ledger and mirror it
        as gauges: rows spent against the budget, station occupancy, the
        page economy, speculation yield, and the host/device split —
        ``host_ms`` is the iteration's host-side time, ``device_ms`` the
        time it spent blocked on the token readback.  The row keys are
        the JAX batcher's; at tensor-parallel width 1 ``tp`` is 1 and
        ``collective_bytes`` 0."""
        rows = self._last_prefill_rows + n_active * (
            (self.speculate_k + 1) if self.speculate_k is not None else 1
        )
        cached = (
            len(self.prefix_cache) if self.prefix_cache is not None else 0
        )
        row = {
            "step": self.stats["steps"],
            "t": time.monotonic(),
            "rows": rows,
            "budget": self.token_budget or 0,
            "station_busy": len(self._jobs),
            "station_slots": self.station_slots,
            "active": n_active,
            "pending": len(self._pending),
            "pages_free": len(self.free_pages),
            "pages_live": self.pages_in_use(),
            "pages_cached": cached,
            "cache_idle": (
                self.prefix_cache.idle_count()
                if self.prefix_cache is not None else 0
            ),
            "decode_pages_sealed": self.stats["decode_pages_sealed"],
            "prefix_hit_tokens": self.stats["prefix_hit_tokens"],
            "spec_tokens": spec_emitted,
            "host_ms": round(host_s * 1e3, 3),
            "device_ms": round(device_s * 1e3, 3),
            "tp": self.tp,
            "collective_bytes": 0,
            "pool_bytes_per_device": self.pool_bytes_per_device,
            "kv_dtype": self.kv_dtype,
            "pool_kv_bytes": self.pool_kv_bytes,
            "pool_scale_bytes": self.pool_scale_bytes,
        }
        self._ledger.append(row)
        if self.metrics is not None:
            self.metrics.set_gauge("serve_step_host_ms", row["host_ms"])
            self.metrics.set_gauge("serve_step_device_ms", row["device_ms"])
            self.metrics.set_gauge("serve_step_rows", float(rows))
            self.metrics.set_gauge("serve_pool_pages_free",
                                   float(row["pages_free"]))
            self.metrics.set_gauge("serve_pool_pages_live",
                                   float(row["pages_live"]))
            self.metrics.set_gauge("serve_pool_pages_cached", float(cached))

    def ledger_rows(self, limit: Optional[int] = None) -> List[dict]:
        """The most recent ledger rows (oldest first), up to ``limit``."""
        rows = list(self._ledger)
        return rows[-limit:] if limit is not None else rows

    # -- the batch convenience loop ----------------------------------------
    @torch.no_grad()
    def run(self, prompts: List[np.ndarray], max_new_tokens: List[int],
            temperatures: Optional[List[float]] = None,
            seeds: Optional[List[Optional[int]]] = None
            ) -> Dict[int, List[int]]:
        """Serve ``prompts`` (request i gets seq_id i) to completion and
        return ``{seq_id: tokens}``."""
        if len(prompts) != len(max_new_tokens):
            raise ValueError("one budget per prompt")
        temps = temperatures or [0.0] * len(prompts)
        pins = seeds or [None] * len(prompts)
        if len(temps) != len(prompts) or len(pins) != len(prompts):
            raise ValueError("one temperature and one seed per prompt")
        self._reset_stats()
        for i, (p, m) in enumerate(zip(prompts, max_new_tokens)):
            self.submit(i, np.asarray(p), m, temps[i], seed=pins[i])
        done: Dict[int, List[int]] = {}
        while self.has_work():
            done.update(self.serve_step())
            if (
                self._pending
                and not self._jobs
                and not any(s.seq_id >= 0 for s in self._seqs)
            ):
                raise RuntimeError(
                    "pool cannot admit the next request though no sequence "
                    "is live — pool_pages too small for the traffic"
                )
        return done
