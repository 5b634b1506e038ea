"""What the replica's serving loop needs from the JAX package's
``gateway/client.py``, as the port's own copy: the keyword sniffs that
decide which optional ``submit`` arguments a batcher takes, and the
prompt-derived stream seed of a SimBatcher-style token mill.  The
gateway side (``Attempt``, ``ReplicaClient`` and its clients) stays in
the JAX package."""

from __future__ import annotations

import inspect


def _sniff_takes(batcher, method: str, param: str) -> bool:
    """Does this batcher's ``method`` accept keyword ``param``?
    Duck-typed once per serving loop, so batchers without the keyword
    still work."""
    try:
        fn = getattr(batcher, method)
        return param in inspect.signature(fn).parameters
    except (AttributeError, TypeError, ValueError):
        return False


def _sniff_takes_trace(batcher, method: str = "submit") -> bool:
    """Trace-context sniff: requests on batchers without the ``trace``
    keyword serve untraced below the replica root."""
    return _sniff_takes(batcher, method, "trace")


def sim_stream_seed(prompt) -> int:
    """Request-deterministic stream seed for a SimBatcher-style mill:
    seeded from the PROMPT (position-weighted, so permutations differ)
    rather than the replica-local slot id, so any replica and any
    resubmission of the same request mills the same tokens — as real
    greedy replicas serving the same weights do."""
    toks = [int(t) for t in prompt]
    return (
        len(toks) * 131
        + sum(t * (i + 1) for i, t in enumerate(toks))
    ) % 1000003
