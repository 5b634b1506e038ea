"""Rank bodies of expert-parallel MoE training: the CPU tests
(``tests/test_torch_moe_train.py``), the card tests
(``tests/test_torch_cuda_moe.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang
(``kubegpu_tpu_torch.parallel.launch.Gang``) over a ``("data",
"expert"[, "model"])`` mesh as ``fn(mesh, spec)``: every rank builds the
same ``MoeTransformerLM`` over the mesh, keeps its shard of the whole
weights (``place_moe``) and trains on its ``"data"`` rows of each global
batch; rank 0 returns the whole trees, after checking that every rank
gathered the same bits (so the parameters every rank holds whole ended
each backward equal along ``"expert"`` and ``"model"``).  Weights and
payloads cross as numpy.  Every body checks that its process never
imported JAX."""

from __future__ import annotations

import time

import numpy as np
import torch

from torch_tp_cases import (
    _agreed,
    _jax_free,
    _np,
    data_rows,
    flash_counts,
    on_mesh,
)

from kubegpu_tpu_torch.models.params import (
    init_moe_params,
    params_from_numpy,
    tree_map,
)


def weights(desc, device):
    """A MoE weight tree from ``desc``: a numpy tree, or ``{"init": cfg,
    "seed": s}``: fresh float32 weights drawn on ``device`` from ``seed``
    (``init_moe_params``), the same on every rank."""
    if isinstance(desc, dict) and "init" in desc:
        gen = torch.Generator(device=device).manual_seed(desc["seed"])
        return init_moe_params(desc["init"], gen, device)
    return tree_map(lambda t: t.to(device), params_from_numpy(desc))


def _rows(mesh, tokens: np.ndarray, device) -> torch.Tensor:
    """This rank's ``"data"`` rows of a global batch (all of them at one
    device)."""
    if mesh is None:
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(device)
    return data_rows(mesh, tokens)


def _agree(mesh, obj):
    return obj if mesh is None else _agreed(mesh, obj)


def _device(mesh, spec: dict):
    return torch.device(spec.get("device", "cpu")) if mesh is None \
        else mesh.device


def moe_state(mesh, spec: dict):
    """This rank's MoE train state from ``spec`` (``mesh`` None: one
    device, ``spec["device"]`` or the CPU, in the caller's process):
    ``params`` (whole
    weights, see :func:`weights`), optional ``opt_state`` (optax's
    layout as numpy), ``optimizer`` and ``step``, ``cfg`` (the model's
    widths and ``num_experts``), ``model`` (``router_type``,
    ``dispatch_impl``, ``attn_impl``, ``remat``, ...) and ``dtype`` (the
    compute type, default float32)."""
    from kubegpu_tpu_torch.models.moe import MoeTransformerLM
    from kubegpu_tpu_torch.models.train import place_moe

    if mesh is not None:
        _jax_free()
    dev = _device(mesh, spec)
    model = MoeTransformerLM(mesh=mesh, dtype=spec.get("dtype", torch.float32),
                             **spec["cfg"], **spec.get("model", {}))
    opt = spec.get("opt_state")
    if opt is not None:
        opt = {k: (weights(v, dev) if isinstance(v, dict)
                   else torch.as_tensor(np.asarray(v)))
               for k, v in opt.items()}
    return place_moe(model, weights(spec["params"], dev), opt_state=opt,
                     optimizer=spec.get("optimizer"),
                     step=spec.get("step", 0))


def _whole(state):
    from kubegpu_tpu_torch.models.train import gather_state

    params, opt_state = gather_state(state)
    return _np(params), {k: _np(v) if isinstance(v, dict)
                         else v.cpu().numpy() for k, v in opt_state.items()}


def moe_grads(mesh, spec: dict) -> dict:
    """One step's loss, aux and gradients, no update (``moe_grads``) on
    ``spec["tokens"][0]``, and the layers' mean drop rate: rank 0
    returns them, every gradient leaf whole, and the flash launches,
    equal on every rank (``mesh`` None: one device's).  ``spec["axes"]``
    lays the gang's world out as that mesh (``torch_tp_cases.on_mesh``)."""
    from kubegpu_tpu_torch.models.moe import moe_router_stats
    from kubegpu_tpu_torch.models.train import grad_tree, moe_grads as grads
    from kubegpu_tpu_torch.parallel.sharding import gather_params, rules_of

    mesh = on_mesh(mesh, spec)
    state = moe_state(mesh, spec)
    tokens = _rows(mesh, spec["tokens"][0], _device(mesh, spec))
    flash_counts(zero=True)
    loss, aux = grads(state, tokens)
    launches = flash_counts()
    whole = gather_params(grad_tree(state), mesh, rules_of(state.model))
    _, drop = moe_router_stats(state.model, tokens[:, :-1])
    return _agree(mesh, dict(loss=loss.item(), aux=aux.item(),
                             drop=drop.item(), grads=_np(whole),
                             launches=launches))


def moe_steps(mesh, spec: dict) -> dict:
    """``moe_step`` on each of ``spec["tokens"]``: rank 0 returns the
    losses and auxes, the whole weights and optimizer state after the
    last step and the step count, equal on every rank."""
    from kubegpu_tpu_torch.models.train import moe_step

    state = moe_state(mesh, spec)
    losses, auxes = [], []
    for t in spec["tokens"]:
        loss, aux = moe_step(state, _rows(mesh, t, _device(mesh, spec)))
        losses.append(loss.item())
        auxes.append(aux.item())
    params, opt_state = _whole(state)
    return _agree(mesh, dict(losses=losses, auxes=auxes, params=params,
                             opt_state=opt_state, step=state.step))


def moe_save_resume(mesh, spec: dict) -> dict:
    """Checkpointed MoE training against an uninterrupted run on this
    mesh: ``moe_step`` on all of ``spec["tokens"]``; then from the same
    state the first ``spec["save_after"]`` batches, a save into
    ``spec["dir"]``, a fresh state (weights from ``spec["fresh"]``)
    restored from it and the remaining batches.  Rank 0 returns both
    runs' losses, whole weights, optimizer states and steps, equal on
    every rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
        save_checkpoint,
    )
    from kubegpu_tpu_torch.models.train import moe_step

    tokens, k = spec["tokens"], spec["save_after"]

    def run(state, batches):
        return [moe_step(state, data_rows(mesh, t))[0].item()
                for t in batches]

    def whole(state, losses):
        params, opt_state = _whole(state)
        return dict(losses=losses, params=params, opt_state=opt_state,
                    step=state.step)

    state = moe_state(mesh, spec)
    straight = whole(state, run(state, tokens))
    state = moe_state(mesh, spec)
    first = run(state, tokens[:k])
    mgr = make_manager(spec["dir"])
    save_checkpoint(mgr, state)
    fresh = moe_state(mesh, dict(spec, params=spec["fresh"]))
    assert restore_checkpoint(mgr, fresh) is fresh and fresh.step == k
    resumed = whole(fresh, first + run(fresh, tokens[k:]))
    return _agreed(mesh, dict(straight=straight, resumed=resumed))


def moe_restore_whole(mesh, spec: dict) -> dict:
    """A fresh state on this mesh (weights from ``spec["params"]``;
    ``mesh`` None: one CPU device) restored from ``spec["dir"]``,
    gathered whole: rank 0 returns its weights, optimizer state and
    step, equal on every rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
    )

    state = moe_state(mesh, spec)
    assert restore_checkpoint(make_manager(spec["dir"]), state) is state
    params, opt_state = _whole(state)
    return _agree(mesh, dict(params=params, opt_state=opt_state,
                             step=state.step))


def _synced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.monotonic()


def moe_bench_width(mesh, spec: dict) -> dict:
    """``spec["steps"]`` ``moe_step``s at a full width (weights drawn on
    every rank from ``spec["params"]``'s seed, each rank keeping its
    experts) on the global batches ``spec["tokens"]`` (numpy), then this
    rank's numbers: rank 0 returns, in rank order, each rank's losses,
    seconds a step, the bytes of its expert leaves and of all its
    parameters, its flash launches, peak device memory and mesh
    coordinates.  ``spec["axes"]`` lays the gang's world out as that mesh
    (``torch_tp_cases.on_mesh``); the card's memory is given back at the
    end (a shared gang)."""
    from kubegpu_tpu_torch.models.train import moe_step

    mesh = on_mesh(mesh, spec)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = moe_state(mesh, spec)
    flash_counts(zero=True)
    losses, seconds = [], []
    for i in range(spec["steps"]):
        tokens = data_rows(mesh, spec["tokens"][i % len(spec["tokens"])])
        t0 = _synced(dev)
        losses.append(moe_step(state, tokens)[0].item())
        seconds.append(time.monotonic() - t0)
    launches = flash_counts()
    expert_bytes = sum(p.numel() * p.element_size()
                       for n, p in state.model.named_parameters()
                       if n.endswith(("w_up", "w_down")))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in state.model.parameters())
    from kubegpu_tpu_torch.parallel.collectives import gather_objects

    mine = dict(losses=losses, seconds=seconds, expert_bytes=expert_bytes,
                param_bytes=param_bytes, launches=launches,
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
                coords={a: mesh.coord(a) for a in mesh.axis_names})
    del state, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None


def moe_collectives(mesh) -> list:
    """The expert axis's collectives (``copy_to_model``,
    ``reduce_from_model`` and ``psum`` over ``"expert"`` and ``psum``
    over ``"data"``), forward and backward on this rank's input (a ``(2,
    3)`` tensor filled from the rank number) under a rank-dependent
    upstream gradient, and the rank's coordinates: rank 0 returns every
    rank's, in rank order."""
    from kubegpu_tpu_torch.parallel import collectives as c
    from kubegpu_tpu_torch.parallel.collectives import gather_objects

    _jax_free()
    x_in = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 100.0 * mesh.rank
    out = {"coords": {a: mesh.coord(a) for a in mesh.axis_names}}
    for name, fn in (
            ("copy_expert", lambda x: c.copy_to_model(x, mesh, "expert")),
            ("reduce_expert",
             lambda x: c.reduce_from_model(x, mesh, "expert")),
            ("psum_expert", lambda x: c.psum(x, mesh, "expert")),
            ("psum_data", lambda x: c.psum(x, mesh, "data"))):
        x = x_in.clone().requires_grad_()
        y = fn(x)
        y.backward(torch.ones_like(y) * (mesh.rank + 1))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    every = gather_objects(out, mesh)
    return every if mesh.rank == 0 else None
