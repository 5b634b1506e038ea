"""The serving contract shared by the port's batchers and its worker: the
KV storage and decode-page-cache knobs, and request validation.

Own copies of ``resolve_kv_dtype``, ``resolve_decode_page_cache`` and
``_validate_request`` from ``kubegpu_tpu/models/serving.py``, with their
semantics: the pool stores the serving dtype at full width or int8 with
per-page scales, and retirement sealing of decode pages follows the
policy's numerics class (``"quantized"`` seals only on an int8 pool,
``"fp32"`` only on a full-width float32 pool, ``"all"`` always).
"""

from __future__ import annotations

import numpy as np
import torch

DECODE_PAGE_CACHE_POLICIES = ("off", "fp32", "quantized", "all")
KV_DTYPES = ("bf16", "fp32", "int8")


def resolve_kv_dtype(kv_dtype, dtype) -> bool:
    """Resolve the page-pool storage knob against the serving dtype;
    returns whether the pool stores quantized (int8 + scales) pages.
    ``None`` or the full-width name matching the serving dtype is the
    full-width pool; a contradicting or unknown name raises
    ``ValueError``."""
    if kv_dtype is None:
        return False
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES} or None, got {kv_dtype!r}"
        )
    if kv_dtype == "int8":
        return True
    want = {"bf16": torch.bfloat16, "fp32": torch.float32}[kv_dtype]
    if dtype != want:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} contradicts the serving dtype {dtype}: "
            "full-width pools store the compute dtype (pick the matching "
            "name, or 'int8')"
        )
    return False


def resolve_decode_page_cache(policy: str, dtype, kv_quant: bool = False) -> bool:
    """Resolve the decode-page sealing policy against the serving dtype
    and the pool's storage; returns whether decode-produced pages may
    enter the prefix cache.  Unknown policies raise ``ValueError``."""
    if policy not in DECODE_PAGE_CACHE_POLICIES:
        raise ValueError(
            f"decode_page_cache must be one of {DECODE_PAGE_CACHE_POLICIES}, "
            f"got {policy!r}"
        )
    if policy == "off":
        return False
    if policy == "all":
        return True
    if policy == "quantized":
        return kv_quant
    return dtype == torch.float32 and not kv_quant


def validate_request(prompt: np.ndarray, max_new: int, prompt_pad: int,
                     max_seq: int) -> int:
    """The admission contract: returns the prompt length or raises
    ``ValueError`` — checked before any ``max_new <= 0`` short-circuit,
    so an oversized prompt is refused whatever its budget."""
    plen = int(prompt.shape[0])
    if plen < 1:
        raise ValueError("prompt must contain at least one token")
    if plen > prompt_pad:
        raise ValueError(f"prompt length {plen} exceeds prompt_pad {prompt_pad}")
    if plen + max_new > max_seq:
        raise ValueError(
            f"prompt {plen} + max_new {max_new} exceeds max_seq {max_seq}"
        )
    return plen
