"""Paged attention over a shared KV pool: one query token per slot (the
decode step) or a window of L query tokens per slot (the speculative
verify).

The port of ``kubegpu_tpu/ops/paged_attention.py``.  A per-slot PAGE
TABLE maps logical cache pages to physical pages of a pool shared by
every slot; attention walks the table with an f32 online softmax and
reads only the slot's live pages.

Single query (K1), three functions that compute the same thing:

- :func:`reference_paged_attention`: the dense-gather oracle (gather
  every slot's pages, one masked softmax).
- :func:`paged_decode_attention_plain`: the kernel's plain PyTorch twin,
  an f32 online-softmax fold over pages in table order — the same fold
  recipe as the kernel and the Pallas ``_paged_kernel``.
- :func:`paged_decode_attention`: the entry point.  For CUDA tensors it
  launches the hand-written Hopper kernels (``csrc/paged_attention.cu``,
  built at first use) or raises; only CPU tensors take the plain twin.
  ``paged_decode_attention.launches`` counts launches.  A caller
  that has run :func:`check_kernel_args` once on its operands' layout
  (the batcher, on its pools) passes ``checked=True`` to skip the
  per-call checks on the decode step.

Multi query (K2): :func:`reference_paged_chunk_attention`,
:func:`paged_chunk_attention_plain` and :func:`paged_chunk_attention`
(with :func:`check_chunk_args` and ``paged_chunk_attention.launches``),
the same three roles.  Query row j of a window attends columns
``< lengths + j`` (intra-window causal).  Both twins fold every query
row through one per-page helper, so plain K2 row j IS plain K1 at
``lengths + j``, bit for bit.

On the card both entry points run one code path: a slot's page table is
cut into splits of a fixed number of pages (:func:`split_plan`, a
function of the page geometry alone), one block folds one split of one
(slot, head) for up to 8 rows of the window at once (a walk; K1 walks
one row), streaming the pages through a ``cp.async`` ring, and a second
kernel merges each row's splits in split order.  Every row folds with
the one-row walk's operations in its order and merges the splits that
its own length makes live, so the CUDA K2's row j is the CUDA K1's at
``lengths + j`` bit for bit, and a slot's result does not depend on the
batch around it.  :func:`chunk_plan` is K2's ring, :func:`split_plan`
the split and K1's ring; :func:`paged_split_attention_plain` mirrors
the split-and-merge on the CPU, for the tests.

Layouts as in the JAX package: q ``(b, h, hd)`` (K1) or
``(b, L, h, hd)`` (K2); pools ``(pool_pages, h, page, hd)``; page table
``(b, n_pages)`` int32 (tail entries may point at any valid page — they
are never read); lengths ``(b,)`` int32 attendable rows (of query row 0
for K2).  The result has q's shape and dtype; a row with nothing to
attend returns zeros.  The kernels take what the reference serves: any
head width that is a multiple of 8 up to ``MAX_HEAD_DIM``, any window
of ``L >= 1`` rows, and pages of up to ``MAX_KERNEL_PAGE`` rows.

Quantized pools (K1q, K2q): both entry points and both twins take
optional ``k_scale``/``v_scale`` — ``(pool_pages, h)`` float32, one
symmetric scale per page per head, given together or not at all.  The
pools then hold int8 and each page block is cast to f32 and multiplied
by its per-head scale before the fold, in the Pallas kernels' order
(the twins and the CUDA kernels alike; the scale is never folded into q
or the score).  :func:`quantize_pages` / :func:`dequantize_pages` are
the pool's storage codec; the dense oracles take dequantized pools.
The int8 variants count their launches apart:
``paged_decode_attention.int8_launches`` and
``paged_chunk_attention.int8_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kubegpu_tpu_torch.ops import _build

NEG_INF = float("-inf")
# the dtypes the kernels are instantiated for (q and out; a full-width
# pool stores q's dtype, a quantized one int8)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head widths the kernels take: multiples of 8 up to MAX_HEAD_DIM
MAX_HEAD_DIM = 128
# the 232,448 bytes of shared memory an H100 block may opt in to
OPTIN_SMEM_BYTES = 232448
# the kernels' blocks: 128 threads in 4 warps
THREADS = 128
WARPS = THREADS // 32
# K2 folds at most this many query rows in one walk of the pages (kMaxRows)
MAX_ROWS_PER_WALK = 8
# A walk streams its pages through a ring of 2 to MAX_STAGES tiles
# (kMaxStages): K2's of at most TILE_BYTES each, as many as RING_BYTES
# hold; K1's (one row a walk, several blocks an SM) of DECODE_TILE_BYTES,
# as many as DECODE_RING_BYTES hold
MIN_STAGES, MAX_STAGES = 2, 4
TILE_BYTES = 32 * 1024
RING_BYTES = 64 * 1024
DECODE_TILE_BYTES = 16 * 1024
DECODE_RING_BYTES = 32 * 1024
# A split holds MIN_SPLIT_PAGES whole pages, or as many as SPLIT_ROWS
# rows fill where pages are small
MIN_SPLIT_PAGES = 2
SPLIT_ROWS = 64
# A page's f32 scores sit in shared memory, one float per page row,
# beside 32 floats of reductions (4 warps x MAX_ROWS_PER_WALK rows), and
# so does the ring, whose least is two tiles of one 16-byte copy a
# thread: 2 x 128 x 16 bytes, 1024 floats
MAX_KERNEL_PAGE = (OPTIN_SMEM_BYTES // 4 - WARPS * MAX_ROWS_PER_WALK
                   - MIN_STAGES * THREADS * 16 // 4)


def dequantize_pages(data, scale, dtype=torch.float32):
    """Expand a quantized pool to full width: ``data`` (P, h, page, hd)
    int8 times ``scale`` (P, h) broadcast over (page, hd), in float32,
    then cast to ``dtype``."""
    return (data.float() * scale[:, :, None, None]).to(dtype)


def quantize_pages(pages):
    """Per-page, per-head symmetric int8 quantization of full-width pages
    ``(n, h, page, hd)``: returns ``(int8 data, (n, h) float32 scales)``
    with ``scale = amax / 127`` over each page's ``(page, hd)`` block per
    head.  An all-zero block keeps scale 0 and dequantizes to exact
    zeros.  ``torch.round`` rounds half to even, as ``jnp.round`` does;
    the value is clipped before the cast."""
    f = pages.float()
    scale = f.abs().amax(dim=(2, 3)) / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    data = torch.clamp(torch.round(f / safe[:, :, None, None]), -127, 127)
    return data.to(torch.int8), scale


def reference_paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Oracle: gather every slot's pages dense, run one masked softmax in
    f32.  Same signature and result as :func:`paged_decode_attention`."""
    b, h, hd = q.shape
    n_pages = page_table.shape[1]
    page = k_pool.shape[2]
    tbl = page_table.long()
    # (b, n_pages, h, page, hd) -> (b, h, S, hd)
    k = k_pool[tbl].transpose(1, 2).reshape(b, h, n_pages * page, hd)
    v = v_pool[tbl].transpose(1, 2).reshape(b, h, n_pages * page, hd)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) / math.sqrt(hd)
    cols = torch.arange(n_pages * page, device=q.device)[None, None, :]
    scores = torch.where(cols < lengths.long()[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # a length-0 slot: every score is -inf and softmax gives NaN; the
    # kernel's answer there is zeros
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bhs,bhsd->bhd", probs, v.float())
    return out.to(q.dtype)


def reference_paged_chunk_attention(q, k_pool, v_pool, page_table, lengths):
    """Oracle for the multi-query kernel: gather dense, one masked f32
    softmax where query row j attends cols ``< lengths + j``.  Same
    signature and result as :func:`paged_chunk_attention`."""
    b, L, h, hd = q.shape
    n_pages = page_table.shape[1]
    page = k_pool.shape[2]
    S = n_pages * page
    tbl = page_table.long()
    k = k_pool[tbl].transpose(1, 2).reshape(b, h, S, hd)
    v = v_pool[tbl].transpose(1, 2).reshape(b, h, S, hd)
    scores = torch.einsum("blhd,bhsd->bhls", q.float(), k.float()) / math.sqrt(hd)
    cols = torch.arange(S, device=q.device)[None, None, None, :]
    lim = (lengths.long()[:, None]
           + torch.arange(L, device=q.device)[None, :])[:, None, :, None]
    scores = torch.where(cols < lim, scores, NEG_INF)
    # a row with no attendable column gives NaN here and zeros in the
    # kernels, as in reference_paged_attention
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    out = torch.einsum("bhls,bhsd->blhd", probs, v.float())
    return out.to(q.dtype)


def _fold_page(state, qf, k, v, first_col, limit, sm_scale):
    """Fold one page into the f32 online-softmax state ``(m, l, acc)``
    of every slot, in the Pallas kernel's order: page max, ``shift``,
    ``p = exp(s - shift)``, correction, ``l``, ``acc``, with its
    ``isfinite`` guards.  ``k``/``v`` ``(b, h, page, hd)`` f32 are the
    slots' page at logical column ``first_col``; columns at or past
    ``limit`` (b,) are masked, and a slot whose limit does not reach the
    page keeps its state untouched."""
    m, l, acc = state
    page = k.shape[2]
    scores = (qf[:, :, None, :] * k).sum(-1) * sm_scale        # (b, h, page)
    cols = torch.arange(page, device=qf.device) + first_col
    scores = torch.where(cols[None, None, :] < limit[:, None, None],
                         scores, NEG_INF)
    m_cur = scores.amax(-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - shift)
    correction = torch.where(torch.isfinite(m), torch.exp(m - shift), 0.0)
    l_new = correction * l + p.sum(-1, keepdim=True)
    acc_new = acc * correction + (p[..., None] * v).sum(2)
    live = (first_col < limit)[:, None, None]                 # (b, 1, 1)
    return (torch.where(live, m_new, m), torch.where(live, l_new, l),
            torch.where(live, acc_new, acc))


def _page_block(pool, scale, ids):
    """The slots' page ``ids`` (b,) of a pool as f32 ``(b, h, page, hd)``,
    dequantized by the per-head ``scale`` when the pool is int8 (cast,
    then multiply: the Pallas kernels' order)."""
    blk = pool[ids].float()
    if scale is not None:
        blk = blk * scale[ids][:, :, None, None]
    return blk


def _n_live(limit, page: int, width: int) -> int:
    """The most live pages of any slot under ``limit`` (b,) int64, at
    most the table's ``width``."""
    if not limit.numel():
        return 0
    return min(int(((limit + page - 1) // page).clamp(min=0).max().item()),
               width)


def _fold_state(qf, k_pool, v_pool, tbl, limit, pages, k_scale, v_scale):
    """The f32 online-softmax state ``(m, l, acc)`` of one query row per
    slot, ``qf`` (b, h, hd) float32, folded over the table's logical
    ``pages`` in order (columns at or past ``limit`` masked)."""
    b, h, hd = qf.shape
    page = k_pool.shape[2]
    sm_scale = 1.0 / math.sqrt(hd)
    state = (torch.full((b, h, 1), NEG_INF, device=qf.device),
             torch.zeros((b, h, 1), device=qf.device),
             torch.zeros((b, h, hd), device=qf.device))
    for p_i in pages:
        ids = tbl[:, p_i]
        state = _fold_page(state, qf, _page_block(k_pool, k_scale, ids),
                           _page_block(v_pool, v_scale, ids), p_i * page,
                           limit, sm_scale)
    return state


def _fold_slots(q, k_pool, v_pool, tbl, limit, k_scale=None, v_scale=None):
    """One query row per slot, ``q`` (b, h, hd), folded over the slot's
    pages below ``limit`` (b,) int64 in table order; returns the f32
    result ``acc / (l if l else 1)`` (zeros where nothing is
    attendable)."""
    n_live = _n_live(limit, k_pool.shape[2], tbl.shape[1])
    _, l, acc = _fold_state(q.float(), k_pool, v_pool, tbl, limit,
                            range(n_live), k_scale, v_scale)
    return acc / torch.where(l == 0.0, 1.0, l)


def _fold_split_slots(q, k_pool, v_pool, tbl, limit, k_scale, v_scale,
                      pages_per_split: int):
    """:func:`_fold_slots` as the kernels compute it: each split of
    ``pages_per_split`` logical pages folded on its own, then the splits
    merged in split order — ``m = max m_s``, ``c_s = exp(m_s - m)``,
    ``l = sum c_s l_s``, ``acc = sum c_s acc_s`` — skipping a split in
    which a slot folded nothing (``l_s == 0``), and divided once."""
    n_live = _n_live(limit, k_pool.shape[2], tbl.shape[1])
    qf = q.float()
    parts = [_fold_state(qf, k_pool, v_pool, tbl, limit,
                         range(s, min(s + pages_per_split, n_live)),
                         k_scale, v_scale)
             for s in range(0, n_live, pages_per_split)]
    b, h, hd = q.shape
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    for m_s, l_s, _ in parts:
        m = torch.where(l_s != 0.0, torch.maximum(m, m_s), m)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, hd), device=q.device)
    for m_s, l_s, acc_s in parts:
        live = l_s != 0.0
        c = torch.exp(m_s - m)   # NaN only where the split is skipped
        l = torch.where(live, c * l_s + l, l)
        acc = torch.where(live, c * acc_s + acc, acc)
    return acc / torch.where(l == 0.0, 1.0, l)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                 k_scale=None, v_scale=None):
    """The K1 (and, with scales, K1q) kernel's plain twin: fold each
    slot's live pages in table order into f32 running max ``m``,
    denominator ``l`` and numerator ``acc`` (:func:`_fold_page`) and
    finalize with ``acc / (l if l else 1)``."""
    _scales_paired(k_scale, v_scale)
    return _fold_slots(q, k_pool, v_pool, page_table.long(), lengths.long(),
                       k_scale, v_scale).to(q.dtype)


def paged_chunk_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                k_scale=None, v_scale=None):
    """The K2 (K2q) kernel's plain twin: query row j goes through the K1
    twin's fold with limit ``lengths + j`` — so row j equals
    :func:`paged_decode_attention_plain` at ``lengths + j`` bit for
    bit."""
    _scales_paired(k_scale, v_scale)
    tbl, lengths = page_table.long(), lengths.long()
    rows = [_fold_slots(q[:, j].contiguous(), k_pool, v_pool, tbl,
                        lengths + j, k_scale, v_scale)
            for j in range(q.shape[1])]
    return torch.stack(rows, 1).to(q.dtype)


def paged_split_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                k_scale=None, v_scale=None, *,
                                pages_per_split: int):
    """The kernels' split-and-merge in torch ops, a CPU test helper: each
    split of ``pages_per_split`` pages folded by the twins' per-page
    fold, then merged in split order and divided once (see
    :func:`_fold_split_slots`).  ``q`` (b, h, hd) is K1's (K1q's, with
    scales) query; ``q`` (b, L, h, hd) a K2 window, row j folded at
    ``lengths + j``.  With one split (``pages_per_split`` at least the
    table's width) it is :func:`paged_decode_attention_plain` bit for
    bit.  Nothing on the serving path calls it."""
    _scales_paired(k_scale, v_scale)
    if pages_per_split < 1:
        raise ValueError(f"a split holds at least one page, got "
                         f"{pages_per_split}")
    tbl, lengths = page_table.long(), lengths.long()
    if q.dim() == 3:
        return _fold_split_slots(q, k_pool, v_pool, tbl, lengths, k_scale,
                                 v_scale, pages_per_split).to(q.dtype)
    rows = [_fold_split_slots(q[:, j].contiguous(), k_pool, v_pool, tbl,
                              lengths + j, k_scale, v_scale, pages_per_split)
            for j in range(q.shape[1])]
    return torch.stack(rows, 1).to(q.dtype)


def _scales_paired(k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together or not at all")


def check_kernel_args(q, k_pool, v_pool, page_table, lengths,
                      k_scale=None, v_scale=None) -> None:
    """Raise ``ValueError`` unless K1 (K1q, with scales) takes these
    operands."""
    if q.dim() != 3:
        raise ValueError(f"q must be (b, h, hd), got {tuple(q.shape)}")
    _check_operands(q, q.shape[0], *q.shape[1:], k_pool, v_pool,
                    page_table, lengths, k_scale, v_scale)


def check_chunk_args(q, k_pool, v_pool, page_table, lengths,
                     k_scale=None, v_scale=None) -> None:
    """Raise ``ValueError`` unless K2 (K2q, with scales) takes these
    operands."""
    if q.dim() != 4:
        raise ValueError(f"q must be (b, L, h, hd), got {tuple(q.shape)}")
    if q.shape[1] < 1:
        raise ValueError(f"a window needs at least 1 query row, got "
                         f"{q.shape[1]} query rows")
    _check_operands(q, q.shape[0], *q.shape[2:], k_pool, v_pool,
                    page_table, lengths, k_scale, v_scale)


def _check_operands(q, b, h, hd, k_pool, v_pool, page_table, lengths,
                    k_scale, v_scale) -> None:
    _scales_paired(k_scale, v_scale)
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (P, h, page, hd) pairs: "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    n_pool, hp, page, hdp = k_pool.shape
    if (hp, hdp) != (h, hd):
        raise ValueError(f"pool heads/width {(hp, hdp)} != q's {(h, hd)}")
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if k_scale is not None:
        tensors += (k_scale, v_scale)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, pools, scales, table and lengths must share a "
                         "device")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError(
                f"pool dtype {k_pool.dtype} != q dtype {q.dtype}")
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError(f"a scaled pool must be int8, got "
                             f"{k_pool.dtype} / {v_pool.dtype}")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (n_pool, h):
                raise ValueError(
                    f"scales must be ({n_pool}, {h}) float32, got "
                    f"{tuple(s.shape)} {s.dtype}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes a head_dim that is a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, got {hd}")
    if not 1 <= page <= MAX_KERNEL_PAGE:
        raise ValueError(f"page size {page} outside [1, {MAX_KERNEL_PAGE}]: "
                         f"a page's f32 scores must fit the card's opt-in "
                         f"shared memory ({OPTIN_SMEM_BYTES} bytes)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page table and lengths must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match b={b}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and pools must be 16-byte aligned")


def _ring_plan(page: int, hd: int, dtype: torch.dtype, quant: bool,
               most_rows: int, tile_bytes: int, ring_bytes: int):
    """``(rows_per_walk, tile_rows, stages, smem_bytes)`` of a walk of at
    most ``most_rows`` rows: see :func:`chunk_plan`."""
    if not 1 <= page <= MAX_KERNEL_PAGE:
        raise ValueError(f"page size {page} outside [1, {MAX_KERNEL_PAGE}]")
    itemsize = 1 if quant else torch.empty((), dtype=dtype).element_size()
    padded = hd not in (64, 128)
    width = (32 if hd <= 32 else 128) if padded else hd
    vec = 8 if quant and padded else 16 // itemsize
    groups = THREADS // (width // vec)
    row_bytes = width * itemsize
    page_rows = -(-page // groups) * groups
    most_rows = min(most_rows, MAX_ROWS_PER_WALK // 2 if vec > 8
                    else MAX_ROWS_PER_WALK)
    for rows in range(most_rows, 0, -1):
        scores = max(rows * page, groups * width)
        fixed = 4 * (WARPS * MAX_ROWS_PER_WALK + scores + -scores % 4)
        room = OPTIN_SMEM_BYTES - fixed
        tile = (min(tile_bytes, room // MIN_STAGES, page_rows * row_bytes)
                // row_bytes // groups * groups)
        if tile >= groups:
            tile_bytes = tile * row_bytes
            stages = max(MIN_STAGES, min(MAX_STAGES, ring_bytes // tile_bytes,
                                         room // tile_bytes))
            return rows, tile, stages, fixed + stages * tile_bytes
    raise AssertionError("MAX_KERNEL_PAGE leaves room for one row")


@functools.lru_cache(maxsize=None)
def chunk_plan(page: int, hd: int, dtype: torch.dtype, quant: bool):
    """K2's (K2q's, ``quant``) launch plan for pages of ``page`` rows,
    head width ``hd`` and q of ``dtype``: ``(rows_per_walk, tile_rows,
    stages, smem_bytes)``.

    It mirrors the kernel's instantiation (``Layout`` in
    ``csrc/paged_attention.cu``): exact at head widths 64 and 128, padded
    to HD 32 or 128 otherwise; 16 bytes of the pool a lane (8 for a padded
    int8 row), HD / those lanes a row, 128 threads, so ``row_groups`` rows
    in flight.  A block folds ``rows_per_walk`` query rows in one walk of
    the pages: at most ``MAX_ROWS_PER_WALK``, or half that where a lane
    holds 16 columns (a full-width int8 pool), whose eight rows' states
    do not fit the registers (``kWalkRows``).  It streams the pages
    through a ring of ``stages`` tiles of ``tile_rows`` rows (a multiple
    of ``row_groups``).  Its shared memory holds 32 reduction floats, the
    walk's f32 scores (``rows_per_walk`` pages of them, at least
    ``row_groups * HD`` floats for the final sum of a row, rounded up to
    16 bytes) and the ring.  The most rows that fit come first, then the
    largest tile up to ``TILE_BYTES`` and the page, then as many stages as
    ``RING_BYTES`` and the room left hold.  The C side recomputes the same
    bytes and refuses a plan that does not fit.  Raises ``ValueError``
    for a page past ``MAX_KERNEL_PAGE``.  K2 splits its pages by
    :func:`split_plan`."""
    return _ring_plan(page, hd, dtype, quant, MAX_ROWS_PER_WALK, TILE_BYTES,
                      RING_BYTES)


@functools.lru_cache(maxsize=None)
def split_plan(page: int, hd: int, dtype: torch.dtype, quant: bool):
    """The split shared by K1 and K2 (K1q and K2q, ``quant``) and K1's
    ring, for pages of ``page`` rows, head width ``hd`` and q of
    ``dtype``: ``(pages_per_split, tile_rows, stages, smem_bytes)``.

    A slot's page table is cut at logical pages ``0, S, 2S, ...``, S =
    ``pages_per_split``: ``MIN_SPLIT_PAGES`` (2) whole pages, so the ring
    fetches one page while the block folds the other, or as many as
    ``SPLIT_ROWS`` (64) rows fill where that is more (a page is never
    cut).  On the card two pages a split was the fastest K1 at both
    serving geometries (pages of 128 and of 32; PERF.md, PR 9).  One
    block folds one split; the merge adds the splits up in order.  The
    plan takes the page geometry and nothing else — not the lengths (a
    device tensor, never read on the host, so a call can be captured in
    a CUDA graph), nor the batch, the window or the table's width — so
    K1 at ``lengths + j`` and row j of a K2 window fold and merge the
    same splits, and a slot's result does not depend on its batch.  K1's one-row walk streams its pages
    through a ring of ``stages`` tiles of ``tile_rows`` rows (up to
    ``DECODE_TILE_BYTES`` a tile, ``DECODE_RING_BYTES`` the ring), with
    ``smem_bytes`` of shared memory, laid out as :func:`chunk_plan`'s at
    one row a walk; the C side recomputes the bytes and refuses a plan
    that does not fit.  Raises ``ValueError`` for a page past
    ``MAX_KERNEL_PAGE``."""
    _, tile, stages, smem = _ring_plan(page, hd, dtype, quant, 1,
                                       DECODE_TILE_BYTES, DECODE_RING_BYTES)
    return max(MIN_SPLIT_PAGES, SPLIT_ROWS // page), tile, stages, smem


def _launch(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale,
            rows: int, ring) -> torch.Tensor:
    """The split walk and the merge over q viewed as (b, rows, h, hd);
    ``ring`` is the walk's (rows_per_walk, tile_rows, stages)."""
    lib = _build.load("paged_attention")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    page, width = k_pool.shape[2], page_table.shape[1]
    quant = k_scale is not None
    pages_per_split = split_plan(page, hd, q.dtype, quant)[0]
    n_splits = max(1, -(-width // pages_per_split))
    # each split's (acc, m, l) per (slot, row, head); allocated per call
    # on q's stream, so a captured call takes it from the graph's pool
    parts = torch.empty((b, rows, h, n_splits, hd + 2), dtype=torch.float32,
                        device=q.device)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quant else (None,
                                                                      None)
    rc = lib.kg_paged_attention(
        KERNEL_DTYPES[q.dtype], int(quant), q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), *scales, page_table.data_ptr(), lengths.data_ptr(),
        parts.data_ptr(), out.data_ptr(), b, rows, h, hd, page, width, *ring,
        pages_per_split, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, "paged attention")
    return out


def _launch_kernel(q, k_pool, v_pool, page_table, lengths, k_scale,
                   v_scale, checked: bool) -> torch.Tensor:
    if not checked:
        check_kernel_args(q, k_pool, v_pool, page_table, lengths, k_scale,
                          v_scale)
    _, tile_rows, stages, _ = split_plan(k_pool.shape[2], q.shape[-1],
                                         q.dtype, k_scale is not None)
    out = _launch(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale,
                  1, (1, tile_rows, stages))
    if k_scale is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.int8_launches += 1
    return out


def _launch_chunk_kernel(q, k_pool, v_pool, page_table, lengths, k_scale,
                         v_scale, checked: bool) -> torch.Tensor:
    if not checked:
        check_chunk_args(q, k_pool, v_pool, page_table, lengths, k_scale,
                         v_scale)
    ring = chunk_plan(k_pool.shape[2], q.shape[-1], q.dtype,
                      k_scale is not None)[:3]
    out = _launch(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale,
                  q.shape[1], ring)
    if k_scale is None:
        paged_chunk_attention.launches += 1
    else:
        paged_chunk_attention.int8_launches += 1
    return out


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: "
                           + lib.kg_cuda_error_string(rc).decode())


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           k_scale=None, v_scale=None,
                           checked: bool = False):
    """Single-token attention over paged KV for every slot (see the
    module docstring for shapes; ``k_scale``/``v_scale`` make it K1q over
    an int8 pool).  CUDA tensors launch the Hopper kernel or raise; CPU
    tensors take :func:`paged_decode_attention_plain`.  ``checked=True``
    skips :func:`check_kernel_args`, for a caller that already ran it on
    the same layout."""
    if q.is_cuda:
        return _launch_kernel(q, k_pool, v_pool, page_table, lengths,
                              k_scale, v_scale, checked)
    return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                        lengths, k_scale, v_scale)


paged_decode_attention.launches = 0        # K1
paged_decode_attention.int8_launches = 0   # K1q


def paged_chunk_attention(q, k_pool, v_pool, page_table, lengths, *,
                          k_scale=None, v_scale=None,
                          checked: bool = False):
    """Multi-query attention over paged KV: L query rows per slot, row j
    attending columns ``< lengths + j`` — a speculative verify window
    whose L rows' K/V are already in the pool (see the module docstring
    for shapes; ``k_scale``/``v_scale`` make it K2q over an int8 pool).
    CUDA tensors launch the Hopper kernel or raise; CPU tensors take
    :func:`paged_chunk_attention_plain`.  ``checked=True`` skips
    :func:`check_chunk_args`, for a caller that already ran it on the
    same layout."""
    if q.is_cuda:
        return _launch_chunk_kernel(q, k_pool, v_pool, page_table, lengths,
                                    k_scale, v_scale, checked)
    return paged_chunk_attention_plain(q, k_pool, v_pool, page_table,
                                       lengths, k_scale, v_scale)


paged_chunk_attention.launches = 0         # K2
paged_chunk_attention.int8_launches = 0    # K2q


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    # dtype, quant; q, pools, scales, table, lengths, workspace, out; b,
    # rows, h, hd, page, table width, the plan (rows per walk, tile rows,
    # stages, pages per split); the softmax scale; the stream
    lib.kg_paged_attention.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr,
    ]
    lib.kg_paged_attention.restype = ctypes.c_int
    lib.kg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kg_cuda_error_string.restype = ctypes.c_char_p


_build.register("paged_attention", "paged_attention.cu", _declare)
