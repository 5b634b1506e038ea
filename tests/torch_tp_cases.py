"""Rank bodies that drive tensor-parallel batchers: the CPU tests
(``tests/test_torch_tp_*.py``, ``tests/test_torch_http_replica.py``),
the card tests (``tests/test_torch_cuda_tp.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang
(``kubegpu_tpu_torch.parallel.launch.Gang``) as ``fn(mesh, *args)``:
every rank builds the same batcher, rank 0 drives it and returns what
the caller compares, the other ranks replay rank 0's calls.  Weights and
payloads cross as numpy.  Every body checks that its process never
imported JAX."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from kubegpu_tpu_torch.models.decoding import quantize_params_int8
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import (
    init_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
)
from kubegpu_tpu_torch.parallel.collectives import gather_objects
from kubegpu_tpu_torch.parallel.replay import follow
from kubegpu_tpu_torch.utils.metrics import Metrics

# the series a TP ledger test reads back from rank 0's registry
METRIC_GAUGES = ("serve_tp_devices", "serve_tp_pool_bytes_per_device",
                 "serve_pool_pages_free")
METRIC_COUNTERS = ("serve_tp_collective_bytes_total",)


def _jax_free() -> None:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                        "kubegpu_tpu"))
    assert not bad, f"a rank imported {bad[:5]}"


COUNTERS = {"K1": (paged_decode_attention, "launches"),
            "K1q": (paged_decode_attention, "int8_launches"),
            "K2": (paged_chunk_attention, "launches"),
            "K2q": (paged_chunk_attention, "int8_launches")}


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    """The paged kernels' launch counters of this process."""
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def weights(desc, device):
    """A weight tree from ``desc``: a numpy tree, or ``{"init": cfg,
    "seed": s, "dtype": torch dtype}`` — fresh float32 weights drawn on
    ``device`` from ``seed`` (as the worker draws them) cast to
    ``dtype``, so every rank draws the same tree without shipping it."""
    if isinstance(desc, dict) and "init" in desc:
        gen = torch.Generator(device=device).manual_seed(desc["seed"])
        tree = init_params(desc["init"], gen, torch.float32, device)
        return tree_map(lambda t: t.to(desc["dtype"]), tree)
    return params_from_numpy(desc)


def make_batcher(mesh, spec: dict):
    """A batcher from ``spec``: ``params`` (see :func:`weights`), ``cfg``,
    ``kw`` (constructor keywords), optional ``draft`` (speculation's
    draft weights, as ``params``), ``quant`` (quantize the weights whole
    first), ``dtype`` (default float32) and ``device`` (default the
    mesh's, else the CPU)."""
    _jax_free()
    device = spec.get("device") or (mesh.device if mesh is not None
                                    else "cpu")
    params = weights(spec["params"], device)
    kw = dict(spec.get("kw", {}))
    if spec.get("quant"):
        params = quantize_params_int8(params)
        kw["quant"] = True
    if spec.get("draft") is not None:
        kw["draft_params"] = weights(spec["draft"], device)
    return PagedContinuousBatcher(params, dtype=spec.get("dtype",
                                                         torch.float32),
                                  device=device, mesh=mesh, **spec["cfg"],
                                  **kw)


def rank_bytes(cb) -> dict:
    """The bytes this rank's pool (pages and scales), station and draft
    ring rest."""
    def nbytes(entries):
        return sum(t.numel() * t.element_size() for kv in entries
                   for e in kv
                   for t in (e if isinstance(e, tuple) else (e,)))

    out = {"pool": nbytes(cb.pools), "station": nbytes(cb._station)}
    if cb.speculate_k is not None:
        out["ring"] = nbytes(cb.d_caches)
    return out


def _drive(cb, prompts, budgets, run_kw, check_every_step: bool):
    """Serve to quiescence on rank 0, checking the page accounting (and
    with it, over a mesh, every rank's host state against rank 0's)
    after every step when asked."""
    if not check_every_step:
        return cb.run(prompts, budgets, **run_kw)
    temps = run_kw.get("temperatures") or [0.0] * len(prompts)
    seeds = run_kw.get("seeds") or [None] * len(prompts)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        cb.submit(i, np.asarray(p), m, temps[i], seed=seeds[i])
    done = {}
    while cb.has_work():
        done.update(cb.serve_step())
        cb.assert_page_accounting()
    return done


def serve(mesh, spec: dict, prompts, budgets, run_kw=None,
          metrics: bool = False, check_every_step: bool = True):
    """Serve one wave.  Rank 0 returns the streams, stats, ledger rows,
    chosen metric values, the pool's declared bytes, the wave's seconds,
    and every rank's resting bytes and kernel launches."""
    cb = make_batcher(mesh, spec)
    zero_counts()
    out = None
    if mesh.rank == 0:
        m = Metrics() if metrics else None
        cb.attach_metrics(m)
        t0 = time.monotonic()
        streams = _drive(cb, prompts, budgets, run_kw or {},
                         check_every_step)
        seconds = time.monotonic() - t0
        cb.assert_page_accounting()
        out = {
            "seconds": seconds,
            "streams": streams,
            "stats": dict(cb.stats),
            "ledger": cb.ledger_rows(),
            "prefix": cb.prefix_cache_stats(),
            "pool_kv_bytes": cb.pool_kv_bytes,
            "pool_scale_bytes": cb.pool_scale_bytes,
            "pool_bytes_per_device": cb.pool_bytes_per_device,
            "tp": cb.tp,
        }
        if m is not None:
            out["gauges"] = {n: m.gauge(n) for n in METRIC_GAUGES}
            out["counters"] = {n: m.get(n) for n in METRIC_COUNTERS}
        cb.close()
    else:
        cb.follow()
    ranks = gather_objects((rank_bytes(cb), launch_counts()), mesh)
    if out is not None:
        out["rank_bytes"] = [b for b, _ in ranks]
        out["rank_launches"] = [n for _, n in ranks]
    return out


def churn(mesh, spec: dict, seed: int, steps: int = 40):
    """A schedule of submits, cancels and steps drawn from ``seed`` (the
    JAX compile-stability test's), then drained; the accounting and
    every rank's host state are checked after every step.  Rank 0
    returns every finished stream by seq id."""
    cb = make_batcher(mesh, spec)
    if mesh.rank != 0:
        cb.follow()
        return None
    done = churn_schedule(cb, seed, spec["cfg"]["vocab_size"], steps)
    cb.close()
    return done


def churn_schedule(cb, seed: int, vocab: int, steps: int) -> dict:
    rng = np.random.RandomState(seed)
    seq, live, done = 0, [], {}
    for _ in range(steps):
        roll = rng.rand()
        if roll < 0.5:
            n = int(rng.randint(1, 13))
            max_new = int(rng.randint(0, 5))
            prompt = (np.arange(n, dtype=np.int32) % 7 if roll < 0.15
                      else rng.randint(0, vocab, size=n).astype(np.int32))
            cb.submit(seq, prompt, max_new)
            live.append(seq)
            seq += 1
        elif roll < 0.6 and live:
            cb.cancel(live.pop(rng.randint(len(live))))
        else:
            for s, toks in cb.serve_step().items():
                live.remove(s)
                done[s] = toks
            cb.assert_page_accounting()
    while cb.has_work():
        for s, toks in cb.serve_step().items():
            live.remove(s)
            done[s] = toks
        cb.assert_page_accounting()
    return done


def _steps_until(cb, seq_id: int, n_tokens: int, max_steps: int = 200):
    for _ in range(max_steps):
        if len(cb.live_tokens().get(seq_id, [])) >= n_tokens:
            return
        cb.serve_step()
    raise AssertionError(f"sequence {seq_id} never reached {n_tokens}")


def _drain(cb) -> dict:
    out = {}
    while cb.has_work():
        out.update(cb.serve_step())
    return out


def export_mid_stream(mesh, spec: dict, prompt, budget: int, after: int,
                      run_kw=None):
    """Decode ``prompt`` until it holds ``after`` tokens, export it, detach
    it (``cancel``) and check the accounting.  Rank 0 returns the
    payload."""
    cb = make_batcher(mesh, spec)
    if mesh.rank != 0:
        cb.follow()
        return None
    run_kw = run_kw or {}
    cb.submit(1, np.asarray(prompt, np.int32), budget,
              run_kw.get("temperature", 0.0), seed=run_kw.get("seed"))
    _steps_until(cb, 1, after)
    payload = cb.export_pages(1)
    cb.cancel(1)
    cb.assert_page_accounting()
    cb.close()
    return payload


def park_and_export(mesh, spec: dict, prompt, budget: int,
                    max_steps: int = 200):
    """Prefill-only serving: step until ``prompt``'s seal is announced
    (``drain_sealed``, rank 0's alone), export the parked sequence and
    detach it.  Rank 0 returns the announcements, the payload and every
    rank's unannounced seals at the end."""
    cb = make_batcher(mesh, dict(spec, kw=dict(spec["kw"],
                                               prefill_only=True)))
    out = None
    if mesh.rank == 0:
        cb.submit(1, np.asarray(prompt, np.int32), budget)
        sealed = []
        for _ in range(max_steps):
            cb.serve_step()
            sealed = cb.drain_sealed()
            if sealed:
                break
        again = cb.drain_sealed()
        payload = cb.export_pages(1)
        cb.cancel(1)
        cb.assert_page_accounting()
        cb.close()
        out = {"sealed": sealed, "again": again, "payload": payload}
    else:
        cb.follow()
    pending = gather_objects(list(cb._sealed_pending), mesh)
    if out is not None:
        out["pending"] = pending
    return out


def import_and_drain(mesh, spec: dict, payload: dict):
    """Import ``payload`` as sequence 10 and decode it to its end; rank 0
    returns the stream and its imported-pages count."""
    cb = make_batcher(mesh, spec)
    if mesh.rank != 0:
        cb.follow()
        return None
    cb.import_pages(10, payload)
    out = _drain(cb)
    cb.assert_page_accounting()
    stats = dict(cb.stats)
    cb.close()
    return {"stream": out[10], "stats": stats}


def migrate_within(mesh, src_spec: dict, dst_spec: dict, prompt,
                   budget: int, after: int, run_kw=None):
    """Two batchers of one mesh: export mid-stream from the first, import
    into the second, drain; both ends' accounting checked.  Rank 0
    returns the continued stream, the payload's geometry and whether a
    draft ring shipped."""
    src, dst = make_batcher(mesh, src_spec), make_batcher(mesh, dst_spec)
    if mesh.rank != 0:
        follow(src, dst)
        return None
    run_kw = run_kw or {}
    src.submit(1, np.asarray(prompt, np.int32), budget,
               run_kw.get("temperature", 0.0), seed=run_kw.get("seed"))
    _steps_until(src, 1, after)
    payload = src.export_pages(1)
    src.cancel(1)
    dst.import_pages(10, payload)
    out = _drain(dst)
    src.assert_page_accounting()
    dst.assert_page_accounting()
    src.close()
    dst.close()
    return {"stream": out[10], "geometry": payload["geometry"],
            "draft": "draft" in payload}


def serve_http(mesh, spec: dict, ctrl_dir: str, step_delay_s: float = 0.01,
               timeout_s: float = 120.0):
    """Rank 0 serves the batcher as a ``ReplicaServer`` on loopback: it
    writes the endpoint to ``ctrl_dir/endpoint`` and serves until
    ``ctrl_dir/stop`` appears (or ``timeout_s`` passes), then returns the
    batcher's stats and tp."""
    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer

    cb = make_batcher(mesh, spec)
    if mesh.rank != 0:
        cb.follow()
        return None
    srv = ReplicaServer(cb, step_delay_s=step_delay_s).start()
    tmp = os.path.join(ctrl_dir, "endpoint.tmp")
    with open(tmp, "w") as f:
        f.write(srv.endpoint)
    os.replace(tmp, os.path.join(ctrl_dir, "endpoint"))
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(os.path.join(ctrl_dir, "stop")):
        if time.monotonic() > deadline:
            break
        time.sleep(0.05)
    srv.stop()
    cb.assert_page_accounting()
    cb.close()
    return {"stats": dict(cb.stats), "tp": cb.tp,
            "error": srv.loop.error}


def two_turns(mesh, spec: dict, turn1):
    """A session's two turns on one sealing batcher: turn 2 extends turn
    1's stream, so it hits the pages turn 1's retirement sealed.  Rank 0
    returns both streams and the sealing and hit counts."""
    cb = make_batcher(mesh, spec)
    if mesh.rank != 0:
        cb.follow()
        return None
    out1 = cb.run([turn1], [8])[0]
    sealed = cb.stats["decode_pages_sealed"]
    turn2 = np.concatenate([turn1, np.asarray(out1, np.int32),
                            np.array([9, 1, 4], np.int32)])
    out2 = cb.run([turn2], [6])[0]
    cb.assert_page_accounting()
    cb.close()
    return {"turn1": out1, "turn2": out2, "decode_pages_sealed": sealed,
            "prefix_hit_tokens_decode": cb.stats["prefix_hit_tokens_decode"]}


def forward_logits(mesh, params, cfg: dict, inputs: dict) -> dict:
    """One forward of each model at this rank's shard: the paged decode
    step (``inputs["pools"]``, whole-head numpy pools, or ``(data,
    scale)`` pairs, each rank taking its heads), the verify window
    (every row's logits) and the dense prefill of ``inputs["prompt"]``.
    Rank 0 returns the float32 logits as numpy."""
    from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
    from kubegpu_tpu_torch.models.paging import PagedDecodeLM
    from kubegpu_tpu_torch.models.params import bind_params
    from kubegpu_tpu_torch.parallel.sharding import shard_params, shard_slice

    _jax_free()
    tp, rank = mesh.size, mesh.rank
    tree = shard_params(weights(params, "cpu"), rank, tp)

    def heads(a):
        return torch.from_numpy(shard_slice(np.asarray(a), 1, rank, tp))

    def pools():
        # fresh for each forward: a forward writes its rows in place
        return [tuple(tuple(heads(x) for x in side)
                      if isinstance(side, tuple) else heads(side)
                      for side in layer)
                for layer in inputs["pools"]]

    table = torch.from_numpy(inputs["table"])
    pos = torch.from_numpy(inputs["pos"])
    out = {}
    with torch.no_grad():
        step = bind_params(PagedDecodeLM(dtype=torch.float32, mesh=mesh,
                                         **cfg), tree)
        out["step"] = step(torch.from_numpy(inputs["tokens"][:, :1]),
                           pools(), table, pos).numpy()
        verify = bind_params(PagedDecodeLM(dtype=torch.float32, mesh=mesh,
                                           all_logits=True, **cfg), tree)
        out["verify"] = verify(torch.from_numpy(inputs["tokens"]),
                               pools(), table, pos).numpy()
        dense = bind_params(DecodeLM(dtype=torch.float32, mesh=mesh, **cfg),
                            tree)
        prompt = torch.from_numpy(inputs["prompt"])
        caches = init_caches(prompt.shape[0], cfg["num_layers"],
                             cfg["num_heads"], cfg["hidden"], cfg["max_seq"],
                             torch.float32, "cpu", tp)
        out["prefill"] = dense(prompt, caches, 0).numpy()
    return out if rank == 0 else None
