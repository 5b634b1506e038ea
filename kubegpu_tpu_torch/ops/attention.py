"""Flash attention, forward and backward: the port of
``kubegpu_tpu/ops/attention.py``'s ``flash_attention``.

Layouts as in the JAX package: q ``(b, sq, h, d)``, k and v
``(b, sk, h, d)`` (BSHD); out has q's shape and dtype; the per-row
logsumexp ``lse`` is dense float32 ``(b, h, sq)`` (the TPU kernel's
``(b*h, nq, 8, block_q)`` is a tiling artifact of its layout).  Causal
attention needs ``sq == sk``; non-causal takes any two lengths.

Four roles, as in ``ops/paged_attention.py``:

- :func:`reference_attention`: the einsum oracle (float32 scores, the
  causal offset form ``kj <= qi + (sk - sq)``, softmax, cast to q's
  dtype).
- The kernels' plain twins, dense float32 with the Pallas kernels'
  guards: :func:`flash_forward_plain` -> ``(out, lse)``;
  :func:`flash_backward_delta_plain` -> ``delta = rowsum(dO * O)``
  from the STORED ``out`` (in q's dtype, the residual the forward
  returned); :func:`flash_backward_dkdv_plain` -> ``(dk, dv)`` and
  :func:`flash_backward_dq_plain` -> ``dq``, which recompute p from the
  lse.  ``operand_dtype=torch.bfloat16`` makes the backward twins round
  p and ds to bf16 before their products (f32 sums, one rounding of the
  result), and the forward twin p before ``p . v`` (``l`` from the
  float32 p): the functions the bf16 kernels compute, and the emulations
  their tolerances are derived from (:func:`bf16_gradient_allowance`
  against the float32 twin, :func:`bf16_emulation_shares` element by
  element and block by block against the emulation itself).
- The kernel wrappers :func:`flash_forward` (K3),
  :func:`flash_backward_delta` (delta's pre-pass),
  :func:`flash_backward_dkdv` (K4) and :func:`flash_backward_dq` (K5):
  CUDA tensors launch the hand-written Hopper kernels of
  ``csrc/flash_attention.cu`` (built at first use) or raise; only CPU
  tensors take the twins.  Each wrapper counts its launches in
  ``.launches``.  In bf16, K3, K4 and K5 run on the tensor cores, K4
  and K5 read a precomputed delta (the pre-pass runs first when none is
  given), and an operand whose data is not 16-byte aligned is copied
  first; in float32 they compute in f32 on the CUDA cores, K4 and K5
  take delta from out per tile and refuse a ``delta=``, and the pre-pass
  takes bf16 only.
- :func:`flash_attention`: the ``torch.autograd.Function`` joining
  them, the counterpart of the JAX ``custom_vjp``.  Its forward saves
  ``(q, k, v, out, lse)`` and no ``s x s`` tensor; its backward runs
  the delta pre-pass once (bf16), then K4 and K5, and returns gradients
  in the inputs' dtypes.

Context parallelism, the port of the JAX ``ring_attention`` and
``ulysses_attention``: q, k and v are this rank's ``(b, s / n, h, d)``
rows of a sequence split in order over the mesh's ``"seq"`` axis of n
ranks (``parallel.collectives`` carries the hops).

- :func:`ring_attention`: K/V blocks rotate one rank a step
  (``ring_shift``) while each resident block folds into this rank's
  softmax state, causal by global position.  Where
  :func:`ring_block_sizes` tiles the shard and q and k have one shape
  the flash body runs (:class:`_RingFlashAttention`): the block owned by
  ``src = (my - step) % n`` runs K3 unmasked (``src < my``), K3 causal
  (the diagonal) or nothing (``src > my``), the partial (out, lse) pairs
  fold by logaddexp, and the backward re-rotates K/V with float32 dK/dV
  travelling beside them, K4 and K5 per block from the global lse after
  one delta pre-pass (bf16).  Other shards take the einsum body
  (:func:`ring_attention_einsum`, float32 online softmax, differentiated
  by autograd through the autograd ``ring_shift``), as in JAX.
- :func:`ulysses_attention`: an all-to-all from rows to heads, flash
  attention (K3, K4, K5) on this rank's ``h / n`` heads over the whole
  sequence, an all-to-all back.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from kubegpu_tpu_torch.ops import _build
from kubegpu_tpu_torch.parallel.collectives import (
    heads_to_seq,
    ring_shift,
    seq_to_heads,
)
from kubegpu_tpu_torch.parallel.mesh import SEQ_AXIS

NEG_INF = float("-inf")
# the dtypes the kernels are instantiated for
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head widths the kernels take: multiples of 8 up to MAX_HEAD_DIM
MAX_HEAD_DIM = 128
# the absolute term of a bf16 tolerance: f32 noise near zero
BF16_ATOL = 1e-5


def reference_attention(q, k, v, causal: bool = True):
    """Plain einsum attention in float32, the numerics oracle: query row
    i attends column j iff ``j <= i + (sk - sq)`` when causal."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(kj <= qi + (sk - sq), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _check_causal(q, k, causal: bool) -> None:
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash requires sq == sk, got "
                         f"({q.shape[1]}, {k.shape[1]})")


def _scores(q, k, causal: bool):
    """Float32 scores ``(b, h, sq, sk)`` = ``(q . k) * (1/sqrt(d))`` —
    scaled AFTER the dot, as the Pallas kernels scale — and the causal
    mask (None when not causal)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if not causal:
        return scores, None
    sq, sk = q.shape[1], k.shape[1]
    valid = (torch.arange(sk, device=q.device)[None, :]
             <= torch.arange(sq, device=q.device)[:, None])
    return scores, valid


def flash_forward_plain(q, k, v, causal: bool = True, operand_dtype=None):
    """K3's plain twin: dense float32 attention with the Pallas kernel's
    guards.  A row with nothing to attend (``l == 0``) gets out 0 and
    lse -inf.  Returns ``(out, lse)``: out in q's dtype, lse float32
    ``(b, h, sq)``.  ``operand_dtype`` (None or ``torch.bfloat16``) rounds
    p before ``p . v`` only, as the bf16 kernel feeds it to the tensor
    cores: ``l`` is still summed from the float32 p, so lse is unchanged
    bit for bit."""
    _check_causal(q, k, causal)
    scores, valid = _scores(q, k, causal)
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - shift)
    l = p.sum(-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bhqd", _operands(p, operand_dtype),
                       v.float()) / denom
    lse = torch.where(l > 0.0, torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(denom), NEG_INF)
    return _bshd(out.transpose(1, 2), q.dtype), lse[..., 0]


def _bshd(x, dtype):
    """A result in the kernels' layout: contiguous BSHD in ``dtype``."""
    return x.to(dtype).contiguous()


def flash_backward_delta_plain(out, dout):
    """The pre-pass's plain twin: ``delta = rowsum(dO * O)`` in float32
    from the stored out, contiguous ``(b, h, sq)``."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _backward_probs(q, k, v, out, lse, dout, causal: bool, delta=None):
    """The Pallas ``_bwd_block`` algebra on whole tensors: p recomputed
    from lse (0 where masked or where lse is -inf), ``delta =
    rowsum(dO * O)`` from the stored out (or as given), ``ds = p * (dO .
    v - delta) * scale``.  Returns ``(p, ds)`` float32 ``(b, h, sq,
    sk)``."""
    _check_causal(q, k, causal)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores, valid = _scores(q, k, causal)
    lse_col = lse.float()[..., None]
    finite = torch.isfinite(lse_col)
    keep = finite if valid is None else valid & finite
    p = torch.where(keep, torch.exp(scores - torch.where(finite, lse_col, 0.0)),
                    0.0)
    dof = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    if delta is None:
        delta = flash_backward_delta_plain(out, dout)
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    return p, ds


def _operands(x, operand_dtype):
    """x as a product's operand: unchanged, or rounded to operand_dtype
    (and read back in float32)."""
    return x if operand_dtype is None else x.to(operand_dtype).float()


def flash_backward_dkdv_plain(q, k, v, out, lse, dout, causal: bool = True,
                              delta=None, operand_dtype=None):
    """K4's plain twin: ``dv = p^T . dO``, ``dk = ds^T . q`` in float32,
    returned in k's and v's dtypes.  ``operand_dtype`` (None or
    ``torch.bfloat16``) rounds p and ds before their products."""
    p, ds = _backward_probs(q, k, v, out, lse, dout, causal, delta)
    p, ds = _operands(p, operand_dtype), _operands(ds, operand_dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return _bshd(dk, k.dtype), _bshd(dv, v.dtype)


def flash_backward_dq_plain(q, k, v, out, lse, dout, causal: bool = True,
                            delta=None, operand_dtype=None):
    """K5's plain twin: ``dq = ds . k`` in float32, returned in q's
    dtype.  ``operand_dtype`` as for :func:`flash_backward_dkdv_plain`."""
    _, ds = _backward_probs(q, k, v, out, lse, dout, causal, delta)
    ds = _operands(ds, operand_dtype)
    return _bshd(torch.einsum("bhqk,bkhd->bqhd", ds, k.float()), q.dtype)


def bf16_gradient_allowance(emulation_err: float) -> float:
    """The tolerance of a bf16 backward kernel's gradient against the
    float32 twin: twice the error of the bf16 emulation (the twin at
    ``operand_dtype=torch.bfloat16``, which rounds p and ds as the kernel
    does) against that same twin, plus ``BF16_ATOL`` for gradients near
    zero.  The kernel rounds the same values at the same points, its
    sums in another order, so its error is the emulation's in size."""
    return 2.0 * emulation_err + BF16_ATOL


# A bf16 backward kernel against the emulation itself.  The two round the
# same p and ds at the same points; where the f32 values they round differ
# by sum-order noise, one p or ds lands a bf16 step away and moves its sums
# by a step of that term, and the result's own rounding adds a step more.
# So an element may differ by two steps of its value (2^-6) plus a small
# share of the gradient's rms, and each block of EMULATION_BLOCK rows (per
# batch and head, the rows one warpgroup owns) by 2^-7 of its norm.
EMULATION_ELEMENT_RTOL = 2 ** -6
EMULATION_ELEMENT_RMS = 2 ** -4
EMULATION_BLOCK_RTOL = 2 ** -7
EMULATION_BLOCK = 64


def bf16_emulation_shares(got, emu) -> tuple:
    """How far a bf16 gradient ``got`` (BSHD) lies from the emulation
    ``emu``: ``(worst element's share, worst block's share)`` of the
    allowances above, each at most 1 where the kernel passes.  An element
    may differ by ``EMULATION_ELEMENT_RTOL * |emu| + EMULATION_ELEMENT_RMS
    * rms(emu) + BF16_ATOL``; a block of ``EMULATION_BLOCK`` rows of one
    batch and head by ``EMULATION_BLOCK_RTOL * ||emu block|| +
    BF16_ATOL``."""
    g, e = got.float(), emu.float()
    diff = g - e
    rms = e.square().mean().sqrt()
    element = (diff.abs() / (EMULATION_ELEMENT_RTOL * e.abs()
                             + EMULATION_ELEMENT_RMS * rms + BF16_ATOL)).max()
    b, s, h, d = e.shape
    blocks = -(-s // EMULATION_BLOCK)
    pad = (0, 0, 0, 0, 0, blocks * EMULATION_BLOCK - s)

    def norms(x):
        x = torch.nn.functional.pad(x, pad)
        return x.view(b, blocks, EMULATION_BLOCK, h, d).square().sum(
            (2, 4)).sqrt()

    block = (norms(diff) / (EMULATION_BLOCK_RTOL * norms(e) + BF16_ATOL)).max()
    return element.item(), block.item()


def check_flash_args(q, k, v, causal: bool) -> None:
    """Raise ``ValueError`` unless the kernels take these operands."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (b, sq, h, d) and k, v one (b, sk, h, d) "
                         f"shape: {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v batch, heads or width {tuple(k.shape)} differ "
                         f"from q's {tuple(q.shape)}")
    _check_causal(q, k, causal)
    if sq < 1 or k.shape[1] < 1 or b < 1 or h < 1:
        raise ValueError(f"empty attention {tuple(q.shape)} / {tuple(k.shape)}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must share a device")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k/v dtype {k.dtype}/{v.dtype} != q dtype {q.dtype}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes a head_dim that is a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous BSHD")


def _check_backward_args(q, k, v, out, lse, dout, causal: bool,
                         delta=None) -> None:
    check_flash_args(q, k, v, causal)
    b, sq, h, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if delta is not None and (
            delta.shape != (b, h, sq) or delta.dtype != torch.float32
            or delta.device != q.device or not delta.is_contiguous()):
        raise ValueError(f"delta must be contiguous float32 {(b, h, sq)}, "
                         f"got {tuple(delta.shape)} {delta.dtype}")


def _kernel_args(q, k, causal: bool):
    """The shape arguments every kernel entry takes after its pointers,
    and the stream."""
    b, sq, h, d = q.shape
    return (b, h, sq, k.shape[1], d, 1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)


def _require_card() -> None:
    # a tensor off the CPU goes to a kernel, never to a twin
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: flash attention "
                           "launches its kernels for non-CPU tensors")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: "
                           + lib.kg_cuda_error_string(rc).decode())


def flash_forward(q, k, v, causal: bool = True):
    """Flash attention forward, ``(out, lse)`` (see the module docstring
    for shapes).  CUDA tensors launch K3 or raise; CPU tensors take
    :func:`flash_forward_plain`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal)
    _require_card()
    check_flash_args(q, k, v, causal)
    if q.dtype == torch.bfloat16:
        q, k, v = (_aligned(t) for t in (q, k, v))
    lib = _build.load("flash_attention")
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = lib.kg_flash_forward(
        KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_kernel_args(q, k, causal))
    flash_forward.launches += 1
    _raise_on(lib, rc, "flash forward")
    return out, lse


flash_forward.launches = 0


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (a view
    at an odd element offset): the bf16 kernels load 16 bytes at a time
    and their TMA maps want aligned bases."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_delta(q, delta) -> None:
    if delta is not None and q.dtype != torch.bfloat16:
        raise ValueError(f"delta= is for the bf16 kernels; the {q.dtype} "
                         f"kernels take delta from out")


def flash_backward_delta(out, dout):
    """``delta = rowsum(dO * O)``, float32 ``(b, h, sq)``: the bf16
    backward's pre-pass, which K4 and K5 read (other dtypes raise).  CUDA
    tensors launch its kernel or raise; CPU tensors take
    :func:`flash_backward_delta_plain`."""
    if out.dtype != torch.bfloat16:
        raise ValueError(f"the delta pre-pass takes bfloat16, got {out.dtype}")
    if out.device.type == "cpu":
        return flash_backward_delta_plain(out, dout)
    _require_card()
    if (out.dim() != 4 or dout.shape != out.shape or dout.dtype != out.dtype
            or dout.device != out.device):
        raise ValueError(f"out and dout must be one (b, sq, h, d) shape and "
                         f"dtype: {tuple(out.shape)} {out.dtype} / "
                         f"{tuple(dout.shape)} {dout.dtype}")
    # out stands in for q, k and v: the checks are on its shape and dtype
    check_flash_args(out, out, out, False)
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    out, dout = _aligned(out), _aligned(dout)
    lib = _build.load("flash_attention")
    b, sq, h, d = out.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    rc = lib.kg_flash_backward_delta(
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), b, h, sq, d,
        torch.cuda.current_stream(out.device).cuda_stream)
    flash_backward_delta.launches += 1
    _raise_on(lib, rc, "flash backward delta")
    return delta


flash_backward_delta.launches = 0


def _bf16_operands(q, k, v, out, dout, delta):
    """The operands a bf16 backward kernel entry takes: each 16-byte
    aligned, and delta (computed here when not given).  float32 operands
    pass unchanged, with no delta: those kernels take it from out per
    tile."""
    if q.dtype != torch.bfloat16:
        return q, k, v, out, dout, None
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    if delta is None:
        delta = flash_backward_delta(out, dout)
    return q, k, v, out, dout, delta


def flash_backward_dkdv(q, k, v, out, lse, dout, causal: bool = True,
                        delta=None):
    """``(dk, dv)`` of flash attention.  CUDA tensors launch K4 or
    raise; CPU tensors take :func:`flash_backward_dkdv_plain`.  ``delta``
    is :func:`flash_backward_delta`'s result where the caller has it (bf16
    only)."""
    _check_delta(q, delta)
    if q.device.type == "cpu":
        return flash_backward_dkdv_plain(q, k, v, out, lse, dout, causal,
                                         delta)
    _require_card()
    _check_backward_args(q, k, v, out, lse, dout, causal, delta)
    q, k, v, out, dout, delta = _bf16_operands(q, k, v, out, dout, delta)
    lib = _build.load("flash_attention")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib.kg_flash_backward_dkdv(
        KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        None if delta is None else delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_kernel_args(q, k, causal))
    flash_backward_dkdv.launches += 1
    _raise_on(lib, rc, "flash backward dK/dV")
    return dk, dv


flash_backward_dkdv.launches = 0


def flash_backward_dq(q, k, v, out, lse, dout, causal: bool = True,
                      delta=None):
    """``dq`` of flash attention.  CUDA tensors launch K5 or raise; CPU
    tensors take :func:`flash_backward_dq_plain`.  ``delta`` as for
    :func:`flash_backward_dkdv`."""
    _check_delta(q, delta)
    if q.device.type == "cpu":
        return flash_backward_dq_plain(q, k, v, out, lse, dout, causal, delta)
    _require_card()
    _check_backward_args(q, k, v, out, lse, dout, causal, delta)
    q, k, v, out, dout, delta = _bf16_operands(q, k, v, out, dout, delta)
    lib = _build.load("flash_attention")
    dq = torch.empty_like(q)
    rc = lib.kg_flash_backward_dq(
        KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        None if delta is None else delta.data_ptr(), dq.data_ptr(),
        *_kernel_args(q, k, causal))
    flash_backward_dq.launches += 1
    _raise_on(lib, rc, "flash backward dQ")
    return dq


flash_backward_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: out + lse are the only softmax residuals;
    the backward recomputes p blockwise inside K4 and K5, which in bf16
    share one delta pre-pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (flash_backward_delta(out, dout)
                 if q.dtype == torch.bfloat16 else None)
        dk, dv = flash_backward_dkdv(q, k, v, out, lse, dout, ctx.causal,
                                     delta)
        dq = flash_backward_dq(q, k, v, out, lse, dout, ctx.causal, delta)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention, BSHD, differentiable: O(seq) memory in both
    directions (the forward keeps out and the lse; the backward
    recomputes scores blockwise).  CUDA tensors run K3 forward and K4,
    K5 backward (in bf16 after the delta pre-pass), or raise; CPU tensors
    run the plain twins."""
    return _FlashAttention.apply(q, k, v, causal)


# -- context parallelism: ring and Ulysses attention --------------------------


def ring_block_sizes(s_loc: int) -> Optional[tuple]:
    """The JAX ``_ring_block_sizes``: the Pallas blocks of a ring shard
    of ``s_loc`` rows, or None where the shard does not tile without
    padding (those shards take the einsum body).  The port's kernels take
    any shard; the rule is kept so that each shape takes the reference's
    numerics."""
    if s_loc <= 128 or (s_loc <= 512 and s_loc % 128 == 0):
        return s_loc, s_loc
    for b in (512, 256, 128):
        if s_loc % b == 0:
            return b, b
    return None


def ring_attention_einsum(q, k, v, mesh, causal: bool = True):
    """The JAX ``_ring_attention_einsum``: the float32 online softmax
    over K/V blocks rotating along ``"seq"``, masked by global position
    when causal; ``n - 1`` rotations, the last block folded after them.
    Differentiated by autograd (each hop's gradient shifts back).  An
    ``(s / n)^2`` float32 score tensor a step."""
    size, my = mesh.axis_size(SEQ_AXIS), mesh.coord(SEQ_AXIS)
    b, s_loc, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    qf = q.float()
    rows = torch.arange(s_loc, device=q.device)
    q_pos = my * s_loc + rows

    def fold_block(o, m, l, k_cur, v_cur, step):
        src = (my - step) % size                  # the block's owner
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              k_cur.float()) * sm_scale
        if causal:
            k_pos = src * s_loc + rows
            scores = torch.where(k_pos[None, :] <= q_pos[:, None], scores,
                                 NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - shift[..., None])
        correction = torch.where(torch.isfinite(m), torch.exp(m - shift),
                                 0.0)
        l_new = correction * l + p.sum(-1)
        o_new = o * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_cur.float())
        return o_new, m_new, l_new

    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_loc), device=q.device)
    k_cur, v_cur = k, v
    for step in range(size - 1):
        o, m, l = fold_block(o, m, l, k_cur, v_cur, step)
        k_cur = ring_shift(k_cur, mesh)
        v_cur = ring_shift(v_cur, mesh)
    o, m, l = fold_block(o, m, l, k_cur, v_cur, size - 1)
    denom = torch.where(l == 0.0, 1.0, l)
    return (o / denom[..., None]).transpose(1, 2).to(q.dtype).contiguous()


def _ring_block(my: int, size: int, step: int, causal: bool):
    """The JAX ``_ring_causal_dispatch``: how the block resident at
    ``step`` (owned by ``src = (my - step) % size``) is attended:
    ``False`` unmasked (``src < my``, or not causal), ``True`` causal
    (the diagonal), None skipped (``src > my``: every key lies after
    every query)."""
    if not causal:
        return False
    src = (my - step) % size
    if src == my:
        return True
    return False if src < my else None


def _bshd_weight(w):
    """A ``(b, h, s)`` weight as a ``(b, s, h, 1)`` factor of BSHD."""
    return w.transpose(1, 2)[..., None]


def _fold(o, lse, o_blk, lse_blk):
    """Fold a block's float32 (out, lse) into the running pair: the JAX
    ring's guarded logaddexp algebra."""
    lse_new = torch.logaddexp(lse, lse_blk)
    shift = torch.where(torch.isfinite(lse_new), lse_new, 0.0)
    w_acc = torch.where(torch.isfinite(lse), torch.exp(lse - shift), 0.0)
    w_blk = torch.where(torch.isfinite(lse_blk), torch.exp(lse_blk - shift),
                        0.0)
    return o * _bshd_weight(w_acc) + o_blk * _bshd_weight(w_blk), lse_new


class _RingFlashAttention(torch.autograd.Function):
    """The JAX ``_ring_attention_flash`` custom VJP over K3, K4 and K5.

    Forward: each resident block runs K3 (unmasked or causal) or is
    skipped (:func:`_ring_block`); its out, in q's dtype, is read as
    float32 and folds with its lse into the state (:func:`_fold`).  Only
    ``(q, k, v, out, lse)`` are saved, lse being the global one.

    Backward: K/V rotate again with float32 dK/dV accumulators beside
    them; each non-skipped block runs K4 and K5 from the global out and
    lse (in bf16 from one delta pre-pass of the global out and dO), dQ
    accumulating here; after the last block only dK/dV take the hop
    that brings them home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        size, my = mesh.axis_size(SEQ_AXIS), mesh.coord(SEQ_AXIS)
        b, s_loc, h, d = q.shape
        o = torch.zeros((b, s_loc, h, d), dtype=torch.float32,
                        device=q.device)
        lse = torch.full((b, h, s_loc), NEG_INF, device=q.device)
        k_cur, v_cur = k, v
        for step in range(size):
            if step:
                k_cur, v_cur = ring_shift([k_cur, v_cur], mesh)
            block = _ring_block(my, size, step, causal)
            if block is not None:
                o_blk, lse_blk = flash_forward(q, k_cur, v_cur, block)
                o, lse = _fold(o, lse, o_blk.float(), lse_blk)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh = ctx.mesh
        size, my = mesh.axis_size(SEQ_AXIS), mesh.coord(SEQ_AXIS)
        dout = dout.contiguous()
        delta = (flash_backward_delta(out, dout)
                 if q.dtype == torch.bfloat16 else None)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for step in range(size):
            if step:
                # the gradients travel with their blocks
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv],
                                                  mesh)
            block = _ring_block(my, size, step, ctx.causal)
            if block is None:
                continue
            dk_c, dv_c = flash_backward_dkdv(q, k_cur, v_cur, out, lse, dout,
                                             block, delta)
            dq_c = flash_backward_dq(q, k_cur, v_cur, out, lse, dout, block,
                                     delta)
            dq = dq + dq_c.float()
            dk = dk + dk_c.float()
            dv = dv + dv_c.float()
        # the homing hop: each dK/dV lands on its block's owner
        dk, dv = ring_shift([dk, dv], mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, mesh, causal: bool = True, impl: str = "flash"):
    """Ring attention over this rank's ``(b, s / n, h, d)`` shards of a
    sequence split over ``"seq"`` (the JAX ``ring_attention``): equal to
    attention over the whole sequence, causal by global position.
    ``impl="flash"`` runs the flash body (K3 forward, K4 and K5 backward,
    O(s / n) memory both ways) where :func:`ring_block_sizes` tiles the
    shard and q and k share a shape, else the einsum body, which
    ``impl="einsum"`` always takes."""
    if impl not in ("flash", "einsum"):
        raise ValueError(f"ring impl {impl!r}: 'flash' or 'einsum'")
    if (impl == "flash" and ring_block_sizes(q.shape[1]) is not None
            and q.shape == k.shape):
        return _RingFlashAttention.apply(q, k, v, mesh, causal)
    return ring_attention_einsum(q, k, v, mesh, causal)


def ulysses_attention(q, k, v, mesh, causal: bool = True,
                      use_flash: bool = True):
    """All-to-all sequence parallelism (the JAX ``ulysses_attention``):
    rows -> heads (:func:`seq_to_heads`: every rank's rows of this rank's
    ``h / n`` heads), attention over the whole sequence on those heads
    (:func:`flash_attention`, or :func:`reference_attention` with
    ``use_flash=False``), heads -> rows.  The local head count must
    divide by the axis."""
    size = mesh.axis_size(SEQ_AXIS)
    h = q.shape[2]
    if h % size:
        raise ValueError(
            f"ulysses needs the LOCAL (per-shard) head count ({h}) divisible "
            f"by the '{SEQ_AXIS}' axis size ({size}); with TP-sharded heads "
            f"this is global_heads/tp — replicate heads over TP (heads_axis="
            f"None) or adjust the mesh")
    qg, kg, vg = (seq_to_heads(t, mesh) for t in (q, k, v))
    if use_flash:
        out = flash_attention(qg, kg, vg, causal)
    else:
        out = reference_attention(qg, kg, vg, causal)
    return heads_to_seq(out, mesh)


def _declare(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    shape = [i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.kg_flash_forward.argtypes = [i32, ptr, ptr, ptr, ptr, ptr] + shape
    lib.kg_flash_forward.restype = ctypes.c_int
    lib.kg_flash_backward_delta.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                            i32, ptr]
    lib.kg_flash_backward_delta.restype = ctypes.c_int
    lib.kg_flash_backward_dkdv.argtypes = (
        [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + shape)
    lib.kg_flash_backward_dkdv.restype = ctypes.c_int
    lib.kg_flash_backward_dq.argtypes = (
        [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr] + shape)
    lib.kg_flash_backward_dq.restype = ctypes.c_int
    lib.kg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kg_cuda_error_string.restype = ctypes.c_char_p


_build.register("flash_attention", "flash_attention.cu", _declare)
