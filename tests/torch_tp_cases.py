"""Rank bodies that drive tensor-parallel batchers and data x
tensor-parallel training: the CPU tests (``tests/test_torch_tp_*.py``,
``tests/test_torch_http_replica.py``), the card tests
(``tests/test_torch_cuda_tp*.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang
(``kubegpu_tpu_torch.parallel.launch.Gang``) as ``fn(mesh, *args)``.
Serving: every rank builds the same batcher, rank 0 drives it and
returns what the caller compares, the other ranks replay rank 0's calls.
Training: every rank builds the same model over the mesh, keeps its
shard of the whole weights and trains on its data rows of each global
batch; rank 0 returns the whole trees (after checking every rank's
equal to its own).  Weights and payloads cross as numpy.  Every body
checks that its process never imported JAX."""

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


# -- data x tensor-parallel training ------------------------------------------


def _train_state(mesh, spec: dict):
    """This rank's train state from ``spec``: ``params`` (whole weights,
    see :func:`weights`; float32), optional ``trace`` (the whole momentum
    as numpy), ``optimizer`` (a ``train.Optimizer``, default SGD) and
    ``step``, ``cfg`` (the model's widths), ``model`` (``attn_impl``,
    ``remat``, ``sequence_parallel``), ``dtype`` (the compute type,
    default float32)."""
    from kubegpu_tpu_torch.models.train import place_lm
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    _jax_free()
    model = TransformerLM(mesh=mesh, dtype=spec.get("dtype", torch.float32),
                          **spec["cfg"], **spec.get("model", {}))
    trace = spec.get("trace")
    return place_lm(model, weights(spec["params"], mesh.device),
                    None if trace is None else weights(trace, mesh.device),
                    optimizer=spec.get("optimizer"),
                    step=spec.get("step", 0))


def on_mesh(mesh, spec: dict):
    """The gang's world laid out as ``spec["axes"]`` (``mesh.remesh``: new
    groups over the same ranks), or ``mesh`` itself where ``spec`` names
    no other shape (or ``mesh`` is None: one device): one gang runs
    meshes of several shapes in turn."""
    from kubegpu_tpu_torch.parallel.mesh import remesh

    axes = spec.get("axes")
    if mesh is None or axes is None or dict(axes) == mesh.shape:
        return mesh
    return remesh(mesh, axes)


def data_rows(mesh, tokens: np.ndarray) -> torch.Tensor:
    """This rank's ``"data"`` rows of a global token batch, on its
    device."""
    dp, d = mesh.axis_size("data"), mesh.coord("data")
    n = len(tokens) // dp
    return torch.from_numpy(np.ascontiguousarray(
        tokens[d * n:(d + 1) * n])).to(mesh.device)


def _np(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def _agreed(mesh, obj):
    """``obj`` (a dict of floats, lists and numpy trees) as rank 0 made
    it, after checking that every rank made the same, bit for bit."""
    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), where
        else:
            assert a == b, (where, a, b)

    every = gather_objects(obj, mesh)
    for rank, other in enumerate(every[1:], 1):
        same(every[0], other, f"rank {rank}")
    return every[0] if mesh.rank == 0 else None


FLASH_COUNTERS = ("flash_forward", "flash_backward_dkdv", "flash_backward_dq",
                  "flash_backward_delta")


def flash_counts(zero: bool = False) -> dict:
    """This process's K3, K4, K5 and delta pre-pass launch counts (set to
    0 first when asked)."""
    from kubegpu_tpu_torch.ops import attention

    out = {}
    for name in FLASH_COUNTERS:
        fn = getattr(attention, name)
        if zero:
            fn.launches = 0
        out[name] = fn.launches
    return out


def train_grads(mesh, spec: dict) -> dict:
    """One step's loss and gradients, no update (``lm_grads``) on
    ``spec["tokens"][0]``: rank 0 returns the loss, every gradient leaf
    whole and the flash launches, equal on every rank."""
    from kubegpu_tpu_torch.models.train import grad_tree, lm_grads
    from kubegpu_tpu_torch.parallel.sharding import gather_params

    state = _train_state(mesh, spec)
    flash_counts(zero=True)
    loss = lm_grads(state, data_rows(mesh, spec["tokens"][0]))
    grads = gather_params(grad_tree(state), mesh)
    return _agreed(mesh, dict(loss=loss.item(), grads=_np(grads),
                              launches=flash_counts()))


def train_steps(mesh, spec: dict) -> dict:
    """``lm_step`` on each of ``spec["tokens"]``: rank 0 returns the
    losses, the whole weights and momentum after the last step and the
    step count, equal on every rank."""
    from kubegpu_tpu_torch.models.train import gather_state, lm_step

    state = _train_state(mesh, spec)
    losses = [lm_step(state, data_rows(mesh, t)).item()
              for t in spec["tokens"]]
    params, opt_state = gather_state(state)
    return _agreed(mesh, dict(losses=losses, params=_np(params),
                              momentum=_np(opt_state["trace"]),
                              step=state.step))


def _np_opt(opt_state: dict) -> dict:
    return {k: _np(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in opt_state.items()}


def train_save_resume(mesh, spec: dict) -> dict:
    """Checkpointed training against an uninterrupted run on this mesh:
    ``lm_step`` on all of ``spec["tokens"]`` from the initial state; then
    from the same state the first ``spec["save_after"]`` batches, a save
    into ``spec["dir"]`` (every rank calls ``save_checkpoint``), a fresh
    state (weights drawn from ``spec["fresh"]``, see :func:`weights`)
    restored from that directory and the remaining batches.  Rank 0
    returns both runs' losses, whole weights, optimizer states and steps,
    equal on every rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
        save_checkpoint,
    )
    from kubegpu_tpu_torch.models.train import gather_state, lm_step

    tokens, k = spec["tokens"], spec["save_after"]

    def run(state, batches):
        return [lm_step(state, data_rows(mesh, t)).item() for t in batches]

    def whole(state, losses):
        params, opt_state = gather_state(state)
        return dict(losses=losses, params=_np(params),
                    opt_state=_np_opt(opt_state), step=state.step)

    state = _train_state(mesh, spec)
    straight = whole(state, run(state, tokens))
    state = _train_state(mesh, spec)
    first = run(state, tokens[:k])
    mgr = make_manager(spec["dir"])
    save_checkpoint(mgr, state)
    fresh = _train_state(mesh, dict(spec, params=spec["fresh"]))
    assert restore_checkpoint(mgr, fresh) is fresh and fresh.step == k
    resumed = whole(fresh, first + run(fresh, tokens[k:]))
    return _agreed(mesh, dict(straight=straight, resumed=resumed))


def restore_whole(mesh, spec: dict) -> dict:
    """A fresh state on this mesh (weights from ``spec["params"]``)
    restored from ``spec["dir"]``, gathered whole: rank 0 returns its
    weights, optimizer state and step, equal on every rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
    )
    from kubegpu_tpu_torch.models.train import gather_state

    state = _train_state(mesh, spec)
    restore_checkpoint(make_manager(spec["dir"]), state)
    params, opt_state = gather_state(state)
    return _agreed(mesh, dict(params=_np(params),
                              opt_state=_np_opt(opt_state), step=state.step))


def layernorm_grads(mesh, spec: dict) -> list:
    """The replicated parameters' gradients on every rank straight after
    ``backward()`` and after ``sync_grads``: rank 0 returns, in rank
    order, ``(data coord, model coord, before, after)``."""
    from kubegpu_tpu_torch.models.train import (
        lm_loss,
        replicated_params,
        sync_grads,
    )

    state = _train_state(mesh, spec)
    state.opt.zero_grad(set_to_none=True)
    lm_loss(state.model, data_rows(mesh, spec["tokens"][0])).backward()
    names = {id(p): n for n, p in state.model.named_parameters()}
    ln = replicated_params(state.model)
    before = {names[id(p)]: p.grad.clone().numpy() for p in ln}
    sync_grads(state)
    after = {names[id(p)]: p.grad.clone().numpy() for p in ln}
    every = gather_objects((mesh.coord("data"), mesh.coord("model"), before,
                            after), mesh)
    return every if mesh.rank == 0 else None


def train_flagship(mesh, spec: dict) -> dict:
    """``spec["steps"]`` steps at a full width (weights drawn on every
    rank from ``spec["params"]``'s seed, each rank keeping its shard)
    on ``synthetic_token_batches_for_mesh`` rows, then this rank's
    numbers: rank 0 returns, in rank order, each rank's losses, seconds
    a step, resting parameter and momentum bytes, flash launches, peak
    device memory and mesh coordinates, and the seconds of one more
    step's parts (``parts``), timed after the launches are read."""
    from kubegpu_tpu_torch.models.data import (
        synthetic_token_batches_for_mesh,
    )
    from kubegpu_tpu_torch.models.train import (
        lm_loss,
        lm_step,
        momentum_tree,
        sync_grads,
    )

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = _train_state(mesh, spec)
    cfg = spec["cfg"]
    source = synthetic_token_batches_for_mesh(
        spec["batch"], spec["seq"] + 1, cfg["vocab_size"], mesh,
        seed=spec.get("seed", 0))
    flash_counts(zero=True)
    losses, seconds = [], []
    for _ in range(spec["steps"]):
        tokens = torch.from_numpy(next(source)).to(dev)
        t0 = time.monotonic()
        losses.append(lm_step(state, tokens).item())
        seconds.append(time.monotonic() - t0)
    launches = flash_counts()
    # where a step's time goes, timed after the counts are read: the
    # forward and backward, sync_grads (the LayerNorm sum over "model"
    # and the flat mean over "data"), the optimizer
    t0 = _synced(dev)
    state.opt.zero_grad(set_to_none=True)
    lm_loss(state.model, tokens).backward()
    t1 = _synced(dev)
    sync_grads(state)
    t2 = _synced(dev)
    state.opt.step()
    t3 = _synced(dev)
    parts = dict(forward_backward_s=t1 - t0, sync_grads_s=t2 - t1,
                 optimizer_s=t3 - t2,
                 grad_bytes=sum(p.grad.numel() * p.grad.element_size()
                                for p in state.model.parameters()))

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in _leaves(tree))

    mine = dict(losses=losses, seconds=seconds,
                param_bytes=nbytes(state.params),
                momentum_bytes=nbytes(momentum_tree(state)),
                launches=launches, parts=parts,
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
                coords=(mesh.coord("data"), mesh.coord("model")))
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None


def _synced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.monotonic()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def collective_grads(mesh) -> list:
    """Each training collective's forward and backward on this rank's
    inputs (a ``(2, 4, 3)`` tensor filled from the rank number), plus the
    rank's coordinates and the ranks of its ``"data"`` and ``"model"``
    groups: rank 0 returns every rank's, in rank order."""
    import torch.distributed as dist

    from kubegpu_tpu_torch.parallel import collectives as c

    _jax_free()
    base = torch.arange(24, dtype=torch.float64).reshape(2, 4, 3)
    x_in = base + 100.0 * mesh.rank
    out = {"coords": (mesh.coord("data"), mesh.coord("model")),
           "groups": {a: dist.get_process_group_ranks(mesh.axis_group(a))
                      for a in ("data", "model")}}
    for name in ("copy_to_model", "reduce_from_model", "gather_seq",
                 "scatter_seq", "split_seq", "gather_hidden", "data_mean"):
        x = x_in.clone().requires_grad_()
        y = getattr(c, name)(x, mesh)
        # a rank-dependent upstream gradient
        g = torch.ones_like(y) * (mesh.rank + 1)
        y.backward(g)
        out[name] = (y.detach().numpy(), x.grad.numpy())
    every = gather_objects(out, mesh)
    return every if mesh.rank == 0 else None
