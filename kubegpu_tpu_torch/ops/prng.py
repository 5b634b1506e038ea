"""The counter-based PRNG of the port: the subset of ``jax.random`` that
sampled serving draws from, bit for bit.

The JAX package samples with the default threefry2x32 generator in its
partitionable layout (``jax_threefry_partitionable``, on in JAX 0.9).
These functions compute the same bits from the same keys, so a
seed-pinned sampled stream is the same token sequence in both packages:

- ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``, the key a Python int
  makes with 64-bit mode off (seeds outside the int64 range raise
  ``OverflowError``, as JAX's conversion does);
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
- ``split(key, n)`` hashes the 64-bit counters ``0 .. n-1``, split into
  ``(hi, lo)`` words, and keeps both output words as the new keys;
- ``random_bits(key, shape)`` hashes the 64-bit counters of a row-major
  iota over ``shape`` and XORs the two output words;
- ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
  1, scales to ``[minval, maxval)`` and clamps at ``minval``;
- ``gumbel`` is the low mode, ``-log(-log(uniform(tiny, 1)))``;
- ``categorical`` is gumbel plus argmax over the last axis, the first
  maximum winning.

Keys are ``(..., 2)`` int64 tensors holding uint32 values: torch's
``uint32`` has no add or shifts on the CPU, so every word is an int64
masked to 32 bits after each add and rotate, which gives the same bits
on the CPU and on CUDA.  Every function takes a batch of keys ``(*K,
2)`` and hashes all of them against all counters in one vectorized pass
(``random_bits`` returns ``(*K, *shape)``: each key draws the whole
``shape``, as ``jax.vmap`` over the keys draws), so the number of
launches does not grow with the number of keys.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny
_INT64_RANGE = (-2 ** 63, 2 ** 63 - 1)

Shape = Union[int, Sequence[int]]

# torch's CPU log and exp call MKL's vector math library, which sets
# itself up on its first call; a first call split across threads (a
# large tensor) can run part of itself before that ends, at a relative
# error near 1e-4 (seen in about one process in ten).  One call too small
# to split sets the library up first.
torch.log(torch.ones(1))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast int64 words holding uint32 values: key ``(k1, k2)``,
    counter ``(x1, x2)``.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _as_shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _iota_2x32(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The 64-bit row-major iota over ``shape`` as (hi, lo) words."""
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return (flat >> 32).view(shape), (flat & MASK).view(shape)


def _hash(keys: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Hash counters ``(hi, lo)`` of shape S under every key of ``keys``
    ``(*K, 2)``: returns two ``(*K, *S)`` words."""
    shape = tuple(keys.shape[:-1]) + (1,) * hi.dim()
    k1 = keys[..., 0].reshape(shape)
    k2 = keys[..., 1].reshape(shape)
    return threefry2x32(k1, k2, hi, lo)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a Python int with 64-bit mode
    off: the key ``(0, seed mod 2**32)``, shape (2,)."""
    seed = int(seed)
    if not _INT64_RANGE[0] <= seed <= _INT64_RANGE[1]:
        raise OverflowError(f"seed {seed} does not fit an int64")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``keys`` ``(*K, 2)``,
    ``data`` an int or an integer tensor broadcasting against ``K``
    (wrapped to uint32, as JAX converts an int32 array).  A Python int
    outside ``[0, 2**32)`` raises ``OverflowError``, as in JAX.  Returns
    the folded keys, ``(*broadcast(K, data), 2)``."""
    if isinstance(data, int):
        if not 0 <= data <= MASK:
            raise OverflowError(f"fold_in data {data} is not a uint32")
        # filled where the keys lie: no copy from the host
        data = keys.new_full((), data)
    data = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), -1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split`` of one key ``(2,)`` into ``(*num, 2)`` keys
    (the partitionable layout)."""
    shape = _as_shape(num)
    y1, y2 = _hash(key, *_iota_2x32(shape, key.device))
    return torch.stack([y1, y2], -1)


def random_bits(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element: ``keys`` ``(*K, 2)`` each draw the
    whole ``shape``; returns ``(*K, *shape)`` int64 holding uint32."""
    shape = _as_shape(shape)
    y1, y2 = _hash(keys, *_iota_2x32(shape, keys.device))
    return y1 ^ y2


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``(*K, *shape)`` values in
    ``[minval, maxval)``."""
    bits = random_bits(keys, shape)
    # 23 mantissa bits under the exponent of 1.0: a float in [1, 2)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to float32, as JAX converts them;
    # XLA fuses floats * span + lo into one multiply-add, which float64
    # reproduces (the float32 product is exact there) unless the span is
    # 1, where the product is exact in float32 already
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(lo))
    if span == 1.0:
        out = floats + lo
    else:
        out = (floats.double() * span + lo).float()
    return torch.clamp(out, min=lo)


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, low mode."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (``replace=True``):
    ``keys`` ``(*K, 2)`` and ``logits`` ``(*K, *S)`` — each key perturbs
    its ``S`` block of logits with gumbel noise drawn over ``S`` — and
    the index of the largest perturbed score (the first, on a tie),
    ``(*K, *S[:-1])`` int64."""
    shape = logits.shape[keys.dim() - 1:]
    return torch.argmax(gumbel(keys, shape) + logits, dim=-1)
