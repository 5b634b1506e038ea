"""Rank bodies of pipeline-parallel LM training: the CPU tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_pp_train.py``),
the card tests (``tests/test_torch_cuda_pipeline.py``) and
``chip_smoke.py``.

Each function runs on every rank of a gang
(``kubegpu_tpu_torch.parallel.launch.Gang``) over a ``("pipe"[,
"model"])`` mesh as ``fn(mesh, spec)``, or with ``mesh`` None at one
device in the caller's process (on ``spec["device"]``, default the CPU):
every rank builds the same ``PipelineLM`` over the mesh, keeps its part
of the whole weights (``place_pipeline_lm``) and runs on the same
tokens; rank 0 returns the whole trees, after checking that every rank
gathered the same bits.  Weights and payloads cross as numpy, the block
leaves in the model's layout (``[S, K, ...]``, or circular ``[V, P, K,
...]``).  Every body on a mesh checks that its process never imported
JAX."""

from __future__ import annotations

import time

import numpy as np
import torch

from torch_tp_cases import _agreed, _jax_free, _np, flash_counts, on_mesh

from kubegpu_tpu_torch.models.params import params_from_numpy, tree_map


def _device(mesh, spec: dict) -> torch.device:
    if mesh is None:
        return torch.device(spec.get("device", "cpu"))
    return mesh.device


def _agree(mesh, obj):
    return obj if mesh is None else _agreed(mesh, obj)


def weights(desc, device):
    """A whole tree from ``desc``: a numpy tree, or ``{"init": kw,
    "seed": s}``: fresh float32 weights from ``init_pipeline_lm(**kw)``
    drawn on ``device`` from ``seed`` (the same on every rank), in the
    circular layout over ``kw``'s ``"devices"`` when it names
    ``"num_rounds"`` above 1."""
    from kubegpu_tpu_torch.models.pipeline_lm import (
        init_pipeline_lm,
        to_circular_layout,
    )

    if isinstance(desc, dict) and "init" in desc:
        kw = dict(desc["init"])
        devices, rounds = kw.pop("devices", 1), kw.pop("num_rounds", 1)
        gen = torch.Generator(device=device).manual_seed(desc["seed"])
        tree = init_pipeline_lm(gen, device=device, **kw)
        return to_circular_layout(tree, devices) if rounds > 1 else tree
    return tree_map(lambda t: t.to(device), params_from_numpy(desc))


def pp_model(mesh, spec: dict):
    """``spec["cfg"]``'s ``PipelineLM`` over ``mesh`` (the widths,
    ``num_stages``, ``num_rounds``, ``num_microbatches``,
    ``model_axis``)."""
    from kubegpu_tpu_torch.models.pipeline_lm import PipelineLM

    if mesh is not None:
        _jax_free()
    return PipelineLM(mesh=mesh, **spec["cfg"])


def pp_state(mesh, spec: dict):
    """This rank's train state: ``params`` (whole weights, see
    :func:`weights`), optional ``trace`` (SGD's whole momentum as
    numpy), ``optimizer`` (default non-Nesterov SGD, the JAX worker's)
    and ``step``."""
    from kubegpu_tpu_torch.models.pipeline_lm import place_pipeline_lm
    from kubegpu_tpu_torch.models.train import sgd

    dev = _device(mesh, spec)
    trace = spec.get("trace")
    return place_pipeline_lm(
        pp_model(mesh, spec), weights(spec["params"], dev),
        opt_state=None if trace is None else {"trace": weights(trace, dev)},
        optimizer=spec.get("optimizer", sgd(nesterov=False)),
        step=spec.get("step", 0))


def _whole_grads(state) -> dict:
    from kubegpu_tpu_torch.models.train import grad_tree
    from kubegpu_tpu_torch.parallel.sharding import gather_params

    return _np(gather_params(grad_tree(state), state.mesh,
                             state.model.shard_rules))


def pp_logits(mesh, spec: dict) -> dict:
    """The logits of ``spec["tokens"]`` (numpy, ``(b, t)``) without
    autograd: rank 0 returns them, equal on every rank."""
    state = pp_state(mesh, spec)
    tokens = torch.from_numpy(spec["tokens"]).to(_device(mesh, spec))
    with torch.no_grad():
        logits = state.model(tokens)
    return _agree(mesh, dict(logits=logits.float().cpu().numpy()))


def pp_grads(mesh, spec: dict) -> dict:
    """One step's loss and gradients, no update (``pipeline_lm_grads``)
    on ``spec["tokens"][0]`` (a ``(b, t + 1)`` window): rank 0 returns the
    loss, every gradient leaf whole and the flash launches (none: the
    blocks' attention is einsum), equal on every rank."""
    from kubegpu_tpu_torch.models.pipeline_lm import pipeline_lm_grads

    state = pp_state(mesh, spec)
    tokens = torch.from_numpy(spec["tokens"][0]).to(_device(mesh, spec))
    flash_counts(zero=True)
    loss = pipeline_lm_grads(state, tokens)
    return _agree(mesh, dict(loss=loss.item(), grads=_whole_grads(state),
                             launches=flash_counts()))


def pp_steps(mesh, spec: dict) -> dict:
    """``pipeline_lm_step`` on each of ``spec["tokens"]``: rank 0 returns
    the losses, the first step's whole gradients, the whole weights and
    momentum after the last step, the step count and the flash launches
    (none: the blocks' attention is einsum), equal on every rank.
    ``spec["axes"]`` lays the gang's world out as that mesh
    (``torch_tp_cases.on_mesh``)."""
    from kubegpu_tpu_torch.models.pipeline_lm import (
        pipeline_lm_grads,
        pipeline_lm_step,
    )
    from kubegpu_tpu_torch.models.train import gather_state

    mesh = on_mesh(mesh, spec)
    state = pp_state(mesh, spec)
    dev = _device(mesh, spec)
    batches = [torch.from_numpy(t).to(dev) for t in spec["tokens"]]
    flash_counts(zero=True)
    # step 1 in two halves, to read its gradients before the optimizer
    losses = [pipeline_lm_grads(state, batches[0]).item()]
    grads = _whole_grads(state)
    state.opt.step()
    state.step += 1
    losses += [pipeline_lm_step(state, t).item() for t in batches[1:]]
    params, opt_state = gather_state(state)
    return _agree(mesh, dict(losses=losses, grads=grads, params=_np(params),
                             trace=_np(opt_state["trace"]),
                             step=state.step, launches=flash_counts()))


def stage_chain(mesh, spec: dict) -> dict:
    """``pipeline_apply`` of ``tanh(x @ w)`` stages (``spec["w"]``, the
    whole stack ``[P, d, d]`` or circular ``[V, P, d, d]``, numpy) over
    ``spec["stream"]`` ``[M, ...]`` with ``spec["rounds"]`` rounds, and
    the gradients of the outputs' sum of squares: rank 0 returns the
    outputs, the stream's gradient and every stage's weight gradient
    (gathered whole), equal on every rank."""
    from kubegpu_tpu_torch.parallel.collectives import all_gather
    from kubegpu_tpu_torch.parallel.pipeline import pipeline_apply

    rounds = spec.get("rounds", 1)
    dim = 1 if rounds > 1 else 0
    w = torch.from_numpy(spec["w"])
    if mesh is not None:
        _jax_free()
        w = w.chunk(mesh.axis_size("pipe"), dim)[mesh.coord("pipe")]
    w = w.contiguous().requires_grad_()
    stream = torch.from_numpy(spec["stream"]).requires_grad_()
    run = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"]), mesh,
                         num_rounds=rounds)
    out = run({"w": w}, stream)
    (out * out).sum().backward()
    g_w = w.grad if mesh is None else all_gather(w.grad, mesh, dim,
                                                 axis="pipe")
    return _agree(mesh, dict(out=out.detach().numpy(),
                             g_stream=stream.grad.numpy(),
                             g_w=g_w.numpy()))


def pp_width(mesh, spec: dict) -> dict:
    """``spec["steps"]`` ``pipeline_lm_step``s at a full width (weights
    drawn on every rank from ``spec["params"]``'s seed) on the batches
    ``spec["tokens"]`` (numpy, the same on every rank), then this rank's
    numbers: rank 0 returns, in rank order, each rank's losses, seconds a
    step and the seconds of it in the hops (each hop timed from a
    synchronised card to its result on the card: the host staging and
    the wait for the peer), the bytes of its block leaves and of all its
    parameters, the bytes its hops sent and staged through the host, the
    flash launches, its peak device memory and mesh coordinates.
    ``spec["axes"]`` lays the gang's world out as that mesh
    (``torch_tp_cases.on_mesh``)."""
    from kubegpu_tpu_torch.models.pipeline_lm import pipeline_lm_step
    from kubegpu_tpu_torch.parallel import pipeline
    from kubegpu_tpu_torch.parallel.collectives import (
        CP_TRAFFIC,
        gather_objects,
    )

    mesh = on_mesh(mesh, spec)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = pp_state(mesh, spec)
    batches = [torch.from_numpy(t).to(dev) for t in spec["tokens"]]
    flash_counts(zero=True)
    traffic0 = dict(CP_TRAFFIC)
    losses, seconds, hop_seconds = [], [], []
    in_hops = [0.0]
    plain_hop = pipeline.pipe_hop

    def timed_hop(*args, **kw):
        t0 = _synced(dev)
        out = plain_hop(*args, **kw)
        in_hops[0] += _synced(dev) - t0
        return out

    pipeline.pipe_hop = timed_hop
    try:
        for i in range(spec["steps"]):
            in_hops[0] = 0.0
            t0 = _synced(dev)
            losses.append(pipeline_lm_step(state, batches[i % len(batches)])
                          .item())
            seconds.append(time.monotonic() - t0)
            hop_seconds.append(in_hops[0])
    finally:
        pipeline.pipe_hop = plain_hop
    named = list(state.model.named_parameters())
    mine = dict(
        losses=losses, seconds=seconds, hop_seconds=hop_seconds,
        block_bytes=sum(p.numel() * p.element_size() for n, p in named
                        if n.startswith("blocks.")),
        param_bytes=sum(p.numel() * p.element_size() for _, p in named),
        hop_bytes=CP_TRAFFIC["ring_shift"] - traffic0["ring_shift"],
        staged_bytes=CP_TRAFFIC["host_staged"] - traffic0["host_staged"],
        launches=flash_counts(),
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        coords={a: mesh.coord(a) for a in mesh.axis_names})
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None


def _synced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.monotonic()


def pipe_crossings(mesh) -> list:
    """The ``"pipe"`` crossings on this rank's input (a ``(2, 3)`` tensor
    filled from the rank number): the hop one stage on without and with
    the wrap edge and one stage back, and, under an upstream gradient of
    ``rank + 1``, the entry's and the broadcast's outputs and input
    gradients: rank 0 returns every rank's, in rank order."""
    from kubegpu_tpu_torch.parallel import collectives as c

    _jax_free()
    x_in = (torch.arange(6, dtype=torch.float64).reshape(2, 3)
            + 100.0 * mesh.rank)
    out = {"coord": mesh.coord("pipe"),
           "hop": c.pipe_hop(x_in, mesh, wrap=False).numpy(),
           "hop_wrap": c.pipe_hop(x_in, mesh, wrap=True).numpy(),
           "hop_back": c.pipe_hop(x_in, mesh, step=-1, wrap=False).numpy()}
    for name, fn in (("enter", c.pipe_enter),
                     ("broadcast", c.pipe_broadcast_last)):
        x = x_in.clone().requires_grad_()
        y = fn(x, mesh)
        y.backward(torch.ones_like(y) * (mesh.rank + 1))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    every = c.gather_objects(out, mesh)
    return every if mesh.rank == 0 else None
