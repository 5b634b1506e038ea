"""Paged decode attention: one query token per slot over a shared KV pool.

The port of ``kubegpu_tpu/ops/paged_attention.py``'s single-query path.
A per-slot PAGE TABLE maps logical cache pages to physical pages of a
pool shared by every slot; attention walks the table with an f32 online
softmax and reads only the slot's live pages.

Three functions compute the same thing:

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

Layouts as in the JAX package: q ``(b, h, hd)``; pools
``(pool_pages, h, page, hd)``; page table ``(b, n_pages)`` int32 (tail
entries may point at any valid page — they are never read); lengths
``(b,)`` int32 attendable rows.  Returns ``(b, h, hd)`` in q's dtype; a
length-0 slot returns zeros.
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


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths):
    """The kernel's plain twin: fold the slot's live pages in table order
    into f32 running max ``m``, denominator ``l`` and numerator ``acc``
    — per page: page max, ``shift``, ``p = exp(s - shift)``, correction,
    ``l``, ``acc``, with the Pallas kernel's ``isfinite`` guards — and
    finalize with ``acc / (l if l else 1)``.  Pages at or past a slot's
    length leave its state untouched."""
    b, h, hd = q.shape
    page = k_pool.shape[2]
    sm_scale = 1.0 / math.sqrt(hd)
    lengths = lengths.long()
    tbl = page_table.long()
    qf = q.float()
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, hd), device=q.device)
    n_live = int(((lengths + page - 1) // page).clamp(min=0).max().item()) if b else 0
    for p_i in range(min(n_live, tbl.shape[1])):
        live = (p_i * page < lengths)[:, None, None]            # (b, 1, 1)
        k = k_pool[tbl[:, p_i]].float()                          # (b, h, page, hd)
        v = v_pool[tbl[:, p_i]].float()
        scores = (qf[:, :, None, :] * k).sum(-1) * sm_scale      # (b, h, page)
        cols = torch.arange(page, device=q.device) + p_i * page
        scores = torch.where(cols[None, None, :] < lengths[:, None, None],
                             scores, NEG_INF)
        m_cur = scores.amax(-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - shift)
        correction = torch.where(torch.isfinite(m), torch.exp(m - shift), 0.0)
        l_new = correction * l + p.sum(-1, keepdim=True)
        acc_new = acc * correction + (p[..., None] * v).sum(2)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom).to(q.dtype)


def check_kernel_args(q, k_pool, v_pool, page_table, lengths) -> None:
    """Raise ``ValueError`` unless the kernel takes these operands."""
    b, h, hd = q.shape
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
    if rc != 0:
        raise RuntimeError(
            "paged decode attention kernel failed to launch: "
            + lib.kg_cuda_error_string(rc).decode()
        )
    return out


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


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.kg_paged_decode_attention.argtypes = [
        ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ptr,
    ]
    lib.kg_paged_decode_attention.restype = ctypes.c_int
    lib.kg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kg_cuda_error_string.restype = ctypes.c_char_p


_build.register("paged_attention", "paged_attention.cu", _declare)
