"""One controller over SPMD ranks: rank 0 leads, the other ranks replay
its calls.

The JAX package drives every device from one process.  The port runs
one process per rank, and a batcher's host logic (admission, page
accounting, retirement) must take the same decisions on every rank, so
that every rank runs the same collectives in the same order.  Rank 0
holds the batchers the caller drives: each method marked
:func:`replicated` first broadcasts which batcher, its name and its
arguments over the mesh's control group, then runs.  Every other rank
runs :func:`follow` over its own batchers (built with the same arguments
in the same order), which receives each call and runs it, until rank 0
has closed each of them (:meth:`Replay.close`).  A call made inside a
replicated call (``run`` calls ``submit`` and ``serve_step``) is not
broadcast again.  Read-only queries are not marked: they run on rank 0
alone and run no collective.

A replicated call that raises on rank 0 raises the same error on every
rank (the host state it checks is the same).  A follower records how
each replayed call ended, and rank 0 sends how its own ended with the
next call: a follower whose outcome differs stops with an error instead
of running on out of step.  Arguments named ``trace`` (the caller's
span) stay on rank 0: the other ranks trace nothing."""

from __future__ import annotations

import functools
import inspect
from typing import Dict, Optional

from kubegpu_tpu_torch.parallel.collectives import broadcast_object
from kubegpu_tpu_torch.parallel.mesh import Mesh

RANK_LOCAL_ARGS = ("trace",)


class _Channel:
    """The calls of one mesh on one rank: their nesting depth, how the
    last one ended, and the keys handed to its batchers."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.depth = 0
        self.outcome: Optional[str] = None
        self.next_key = 0

    def run(self, fn, target, args, kwargs):
        self.depth += 1
        try:
            result = fn(target, *args, **kwargs)
        except Exception as e:
            self.outcome = type(e).__name__
            raise
        finally:
            self.depth -= 1
        self.outcome = None
        return result


# one channel per mesh in this process, keyed by the mesh's identity (a
# channel holds its mesh, so the key is never reused while it stands)
_CHANNELS: Dict[int, _Channel] = {}


def _channel(mesh: Mesh) -> _Channel:
    ch = _CHANNELS.get(id(mesh))
    if ch is None:
        ch = _CHANNELS[id(mesh)] = _Channel(mesh)
    return ch


class Replay:
    """A batcher's place on its mesh's channel: every rank numbers its
    batchers in the order it builds them, so a key names the same
    batcher on every rank."""

    def __init__(self, mesh: Mesh) -> None:
        self.channel = _channel(mesh)
        self.key = self.channel.next_key
        self.channel.next_key += 1
        self.closed = False

    def close(self) -> None:
        """Rank 0: release this batcher's followers."""
        ch = self.channel
        if ch.mesh.rank == 0 and not self.closed:
            self.closed = True
            broadcast_object((self.key, None, (), {}, ch.outcome), ch.mesh)


def follow(*targets) -> None:
    """The loop of every rank but 0: run rank 0's calls on ``targets``
    (batchers of one mesh) until rank 0 has closed each.  A replayed
    call's error is rank 0's too (its caller handles it there); the loop
    stops only when rank 0's call ended otherwise."""
    ch = targets[0]._replay.channel
    if ch.mesh.rank == 0:
        raise RuntimeError("rank 0 leads: it makes the calls the other "
                           "ranks follow")
    by_key = {t._replay.key: t for t in targets}
    open_keys = set(by_key)
    last = None
    while open_keys:
        key, name, args, kwargs, lead = broadcast_object(None, ch.mesh)
        if lead != ch.outcome:
            raise RuntimeError(
                f"rank {ch.mesh.rank} left rank 0's step: its {last} ended "
                f"with {ch.outcome or 'a result'}, rank 0's with "
                f"{lead or 'a result'}")
        if key not in by_key:
            raise RuntimeError(f"rank 0 called batcher {key}, which rank "
                               f"{ch.mesh.rank} does not follow")
        target = by_key[key]
        if name is None:
            target._replay.closed = True
            open_keys.discard(key)
            continue
        fn = getattr(type(target), name).__wrapped__
        try:
            ch.run(fn, target, args, kwargs)
        except Exception:   # noqa: BLE001 - ch.outcome is checked above
            pass
        last = name


def replicated(fn):
    """Mark a batcher method as a call every rank runs (see the module
    docstring).  The batcher holds its :class:`Replay` as ``_replay``,
    None on one device."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        rep: Optional[Replay] = self._replay
        if rep is None or rep.channel.depth:
            return fn(self, *args, **kwargs)
        ch = rep.channel
        if ch.mesh.rank != 0:
            raise RuntimeError(
                f"rank {ch.mesh.rank} replays rank 0's calls: it runs "
                f"follow(), not {fn.__name__}()")
        if rep.closed:
            raise RuntimeError("the other ranks were released (close())")
        bound = sig.bind(self, *args, **kwargs)
        for name in RANK_LOCAL_ARGS:
            if name in bound.arguments:
                bound.arguments[name] = None
        broadcast_object((rep.key, fn.__name__, bound.args[1:],
                          bound.kwargs, ch.outcome), ch.mesh)
        return ch.run(fn, self, args, kwargs)

    return wrapper
