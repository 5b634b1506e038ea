"""Training batches: the port of ``kubegpu_tpu/models/data.py``'s
synthetic image and token sources and their device side.

:func:`synthetic_image_batches` is the JAX package's ResNet source bit
for bit: ``(images, labels)`` pairs, NHWC float32 images and int32
labels, from ``SeedSequence([seed, worker_id])``.

:func:`synthetic_token_batches` draws the same token bits as the JAX
package's ``synthetic_token_batches_for_mesh`` on a one-device mesh (one
data shard, seeded ``SeedSequence([seed, 0])``), which is also its
``synthetic_token_batches`` of worker 0.
:func:`synthetic_token_batches_for_mesh` is the per-rank source of a
``("data", "model")``, ``("data", "seq")`` or ``("data", "expert"[,
"model"])`` mesh: each data rank draws its ``batch / dp`` rows from
``SeedSequence([seed, data_coord])``, so the ranks of one data shard
(the ranks that differ only along ``"model"``, ``"seq"`` or
``"expert"``) draw byte-identical rows, as JAX's processes do.  :func:`structured_token_batches` is the JAX package's
learnable stream, bit for bit.  The device side has the JAX
worker's three ``--data`` modes:

- :func:`device_pool_batches` (``synthetic``): ``pool`` batches copied to
  the card once and cycled, so a step reads distinct batches with no
  host-to-device traffic;
- :func:`prefetch_to_device` (``stream``): every batch copied from pinned
  host memory with ``non_blocking=True``, ``depth`` copies in flight ahead
  of the consumer;
- ``resident``: one constant batch, which the worker keeps itself.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from kubegpu_tpu_torch.parallel.mesh import DATA_AXIS


def synthetic_image_batches(batch: int, size: int = 224,
                            num_classes: int = 1000, seed: int = 0,
                            worker_id: int = 0,
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless ``(images, labels)`` host batches: ``(batch, size, size,
    3)`` standard-normal float32 images and ``(batch,)`` int32 labels in
    ``[0, num_classes)``, from ``SeedSequence([seed, worker_id])``, so
    workers draw disjoint streams.  ``batch`` is one worker's rows."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, worker_id]))
    while True:
        images = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
        labels = rng.integers(0, num_classes, size=(batch,), dtype=np.int32)
        yield images, labels


def synthetic_token_batches(batch: int, seq_len: int, vocab_size: int,
                            seed: int = 0, shard: int = 0) -> Iterator[np.ndarray]:
    """Endless int32 token batches ``(batch, seq_len)``, uniform over the
    vocabulary, from ``SeedSequence([seed, shard])``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard]))
    while True:
        yield rng.integers(0, vocab_size, size=(batch, seq_len), dtype=np.int32)


def structured_token_batches(batch: int, seq_len: int,
                             vocab_size: int = 32000, seed: int = 0,
                             worker_id: int = 0,
                             branch_probs: Tuple[float, ...] = (0.7, 0.2, 0.1),
                             ) -> Iterator[np.ndarray]:
    """Endless int32 batches ``(batch, seq_len)`` of LEARNABLE synthetic
    text, bit for bit the JAX package's ``structured_token_batches``:
    each next token is one of three fixed affine successors ``t -> (a_i
    t + b_i) mod vocab`` of the current one, drawn with ``branch_probs``
    (per-token entropy ~0.80 nats at the default).  The successor maps
    come from ``SeedSequence([seed, 104729])`` only, so every worker and
    every held-out stream samples the same language; the trajectories
    come from ``SeedSequence([seed, worker_id, 7])``.  The uniform stream
    (:func:`synthetic_token_batches`) is unlearnable; quality runs use
    this one."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, worker_id, 7]))
    maps = np.random.default_rng(np.random.SeedSequence([seed, 104729]))
    a = (maps.integers(1, vocab_size, size=3) | 1).astype(np.int64)
    b = maps.integers(0, vocab_size, size=3).astype(np.int64)
    probs = np.asarray(branch_probs, np.float64)
    probs = probs / probs.sum()
    k = len(probs)
    while True:
        toks = np.empty((batch, seq_len), np.int64)
        toks[:, 0] = rng.integers(0, vocab_size, size=batch)
        choice = rng.choice(k, size=(batch, seq_len - 1), p=probs)
        for t in range(1, seq_len):
            c = choice[:, t - 1]
            toks[:, t] = (a[c] * toks[:, t - 1] + b[c]) % vocab_size
        yield toks.astype(np.int32)


def synthetic_token_batches_for_mesh(batch: int, seq_len: int,
                                     vocab_size: int, mesh,
                                     seed: int = 0) -> Iterator[np.ndarray]:
    """This rank's rows of endless global ``(batch, seq_len)`` int32 token
    batches over ``mesh`` (the JAX function, one process per device):
    ``batch / dp`` rows a step from ``SeedSequence([seed, d])``, ``d``
    this rank's ``"data"`` coordinate, whatever its other axes (every
    ``"expert"``, ``"model"`` or ``"seq"`` rank of a data shard draws
    the same bytes)."""
    dp = mesh.axis_size(DATA_AXIS)
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by data axis {dp}")
    return synthetic_token_batches(batch // dp, seq_len, vocab_size, seed,
                                   shard=mesh.coord(DATA_AXIS))


def _to_device(batch, device: torch.device):
    """A host batch on ``device``: an array, or a tuple of arrays (an
    image source's ``(images, labels)``) as a tuple of tensors."""
    if isinstance(batch, tuple):
        return tuple(_to_device(b, device) for b in batch)
    host = torch.from_numpy(batch)
    if device.type == "cuda":
        # a pinned source lets the copy run asynchronously to the host
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def device_pool_batches(batches: Iterable, device,
                        pool: int = 8) -> Iterator:
    """Copy ``pool`` batches (arrays, or tuples of arrays) to ``device``
    once, then cycle them forever."""
    dev = torch.device(device)
    it = iter(batches)
    resident = []
    for _ in range(pool):
        try:
            resident.append(_to_device(next(it), dev))
        except StopIteration:
            break  # a short source: cycle what exists
    if not resident:
        raise ValueError("device_pool_batches: source yielded no batches")
    i = 0
    while True:
        yield resident[i % len(resident)]
        i += 1


def prefetch_to_device(batches: Iterable, device,
                       depth: int = 2) -> Iterator:
    """Yield the source's batches (arrays, or tuples of arrays) on
    ``device`` with ``depth`` copies in flight: each batch's copy is
    issued before the consumer needs it, so it overlaps the step
    before."""
    dev = torch.device(device)
    it = iter(batches)
    queue: collections.deque = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                queue.append(_to_device(next(it), dev))
            except StopIteration:
                return

    enqueue(depth)
    while queue:
        yield queue.popleft()
        enqueue(1)
