"""Paged attention over a shared KV pool: one query token per slot (the
decode step) or a window of L query tokens per slot (the speculative
verify).

The port of ``kubegpu_tpu/ops/paged_attention.py``'s full-width paths.
A per-slot PAGE TABLE maps logical cache pages to physical pages of a
pool shared by every slot; attention walks the table with an f32 online
softmax and reads only the slot's live pages.

Single query (K1), three functions that compute the same thing:

- :func:`reference_paged_attention`: the dense-gather oracle (gather
  every slot's pages, one masked softmax).
- :func:`paged_decode_attention_plain`: the kernel's plain PyTorch twin,
  an f32 online-softmax fold over pages in table order — the same fold
  recipe as the kernel and the Pallas ``_paged_kernel``.
- :func:`paged_decode_attention`: the entry point.  For CUDA tensors it
  launches the hand-written Hopper kernel (``csrc/paged_attention.cu``,
  built at first use) or raises; only CPU tensors take the plain twin.
  ``paged_decode_attention.launches`` counts kernel launches.  A caller
  that has run :func:`check_kernel_args` once on its operands' layout
  (the batcher, on its pools) passes ``checked=True`` to skip the
  per-call checks on the decode step.

Multi query (K2): :func:`reference_paged_chunk_attention`,
:func:`paged_chunk_attention_plain` and :func:`paged_chunk_attention`
(with :func:`check_chunk_args` and ``paged_chunk_attention.launches``),
the same three roles.  Query row j of a window attends columns
``< lengths + j`` (intra-window causal).  Both twins fold every query
row through one per-page helper, so plain K2 row j IS plain K1 at
``lengths + j``, bit for bit; the two CUDA kernels share their fold the
same way.

Layouts as in the JAX package: q ``(b, h, hd)`` (K1) or
``(b, L, h, hd)`` (K2); pools ``(pool_pages, h, page, hd)``; page table
``(b, n_pages)`` int32 (tail entries may point at any valid page — they
are never read); lengths ``(b,)`` int32 attendable rows (of query row 0
for K2).  The result has q's shape and dtype; a row with nothing to
attend returns zeros.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubegpu_tpu_torch.ops import _build

NEG_INF = float("-inf")
# the head width and dtypes the kernel is instantiated for
KERNEL_HEAD_DIM = 128
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one f32 score per page row sits in shared memory
MAX_KERNEL_PAGE = 4096
# K2 keeps one online-softmax state per query row in registers: a verify
# window of k+1 rows, k <= 7
MAX_KERNEL_ROWS = 8


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


def _fold_slots(q, k_pool, v_pool, tbl, limit):
    """One query row per slot, ``q`` (b, h, hd), folded over the slot's
    pages below ``limit`` (b,) int64 in table order; returns the f32
    result ``acc / (l if l else 1)`` (zeros where nothing is
    attendable)."""
    b, h, hd = q.shape
    page = k_pool.shape[2]
    sm_scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    state = (torch.full((b, h, 1), NEG_INF, device=q.device),
             torch.zeros((b, h, 1), device=q.device),
             torch.zeros((b, h, hd), device=q.device))
    n_live = int(((limit + page - 1) // page).clamp(min=0).max().item()) if b else 0
    for p_i in range(min(n_live, tbl.shape[1])):
        state = _fold_page(state, qf, k_pool[tbl[:, p_i]].float(),
                           v_pool[tbl[:, p_i]].float(), p_i * page, limit,
                           sm_scale)
    _, l, acc = state
    return acc / torch.where(l == 0.0, 1.0, l)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The K1 kernel's plain twin: fold each slot's live pages in table
    order into f32 running max ``m``, denominator ``l`` and numerator
    ``acc`` (:func:`_fold_page`) and finalize with
    ``acc / (l if l else 1)``."""
    return _fold_slots(q, k_pool, v_pool, page_table.long(),
                       lengths.long()).to(q.dtype)


def paged_chunk_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The K2 kernel's plain twin: query row j goes through the K1 twin's
    fold with limit ``lengths + j`` — so row j equals
    :func:`paged_decode_attention_plain` at ``lengths + j`` bit for
    bit."""
    tbl, lengths = page_table.long(), lengths.long()
    rows = [_fold_slots(q[:, j].contiguous(), k_pool, v_pool, tbl,
                        lengths + j) for j in range(q.shape[1])]
    return torch.stack(rows, 1).to(q.dtype)


def check_kernel_args(q, k_pool, v_pool, page_table, lengths) -> None:
    """Raise ``ValueError`` unless K1 takes these operands."""
    if q.dim() != 3:
        raise ValueError(f"q must be (b, h, hd), got {tuple(q.shape)}")
    _check_operands(q, q.shape[0], *q.shape[1:], k_pool, v_pool,
                    page_table, lengths)


def check_chunk_args(q, k_pool, v_pool, page_table, lengths) -> None:
    """Raise ``ValueError`` unless K2 takes these operands."""
    if q.dim() != 4:
        raise ValueError(f"q must be (b, L, h, hd), got {tuple(q.shape)}")
    if not 1 <= q.shape[1] <= MAX_KERNEL_ROWS:
        raise ValueError(f"window of {q.shape[1]} query rows outside "
                         f"[1, {MAX_KERNEL_ROWS}]")
    _check_operands(q, q.shape[0], *q.shape[2:], k_pool, v_pool,
                    page_table, lengths)


def _check_operands(q, b, h, hd, k_pool, v_pool, page_table, lengths) -> None:
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (P, h, page, hd) pairs: "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _, hp, page, hdp = k_pool.shape
    if (hp, hdp) != (h, hd):
        raise ValueError(f"pool heads/width {(hp, hdp)} != q's {(h, hd)}")
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, pools, table and lengths must share a device")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} != q dtype {q.dtype}")
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    if not 1 <= page <= MAX_KERNEL_PAGE:
        raise ValueError(f"page size {page} outside [1, {MAX_KERNEL_PAGE}]")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page table and lengths must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match b={b}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and pools must be 16-byte aligned")


def _launch_kernel(q, k_pool, v_pool, page_table, lengths,
                   checked: bool) -> torch.Tensor:
    if not checked:
        check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    lib = _build.load("paged_attention")
    b, h, hd = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = lib.kg_paged_decode_attention(
        KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, hd, k_pool.shape[2], page_table.shape[1],
        1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_decode_attention.launches += 1
    _raise_on(lib, rc, "paged decode attention")
    return out


def _launch_chunk_kernel(q, k_pool, v_pool, page_table, lengths,
                         checked: bool) -> torch.Tensor:
    if not checked:
        check_chunk_args(q, k_pool, v_pool, page_table, lengths)
    lib = _build.load("paged_attention")
    b, L, h, hd = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = lib.kg_paged_chunk_attention(
        KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, L, h, hd, k_pool.shape[2], page_table.shape[1],
        1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    paged_chunk_attention.launches += 1
    _raise_on(lib, rc, "paged chunk attention")
    return out


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: "
                           + lib.kg_cuda_error_string(rc).decode())


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *,
                           checked: bool = False):
    """Single-token attention over paged KV for every slot (see the
    module docstring for shapes).  CUDA tensors launch the Hopper kernel
    or raise; CPU tensors take :func:`paged_decode_attention_plain`.
    ``checked=True`` skips :func:`check_kernel_args`, for a caller that
    already ran it on the same layout."""
    if q.is_cuda:
        return _launch_kernel(q, k_pool, v_pool, page_table, lengths,
                              checked)
    return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                        lengths)


paged_decode_attention.launches = 0


def paged_chunk_attention(q, k_pool, v_pool, page_table, lengths, *,
                          checked: bool = False):
    """Multi-query attention over paged KV: L query rows per slot, row j
    attending columns ``< lengths + j`` — a speculative verify window
    whose L rows' K/V are already in the pool (see the module docstring
    for shapes).  CUDA tensors launch the Hopper kernel or raise; CPU
    tensors take :func:`paged_chunk_attention_plain`.  ``checked=True``
    skips :func:`check_chunk_args`, for a caller that already ran it on
    the same layout."""
    if q.is_cuda:
        return _launch_chunk_kernel(q, k_pool, v_pool, page_table, lengths,
                                    checked)
    return paged_chunk_attention_plain(q, k_pool, v_pool, page_table,
                                       lengths)


paged_chunk_attention.launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.kg_paged_decode_attention.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ctypes.c_float, ptr,
    ]
    lib.kg_paged_decode_attention.restype = ctypes.c_int
    lib.kg_paged_chunk_attention.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
    ]
    lib.kg_paged_chunk_attention.restype = ctypes.c_int
    lib.kg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kg_cuda_error_string.restype = ctypes.c_char_p


_build.register("paged_attention", "paged_attention.cu", _declare)
