"""Rank bodies of ZeRO-1 LM training (``kubegpu_tpu_torch/parallel/zero.py``)
over a ``("data"[, "model"])`` mesh: the CPU tests
(``tests/test_torch_zero.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang as ``fn(mesh, spec)``.  Every
rank builds the LM over the mesh and places the whole weights either
with ZeRO-1 (``place_zero1_lm``: the optimizer state cut over
``"data"``) or as plain data parallelism (``train.place_lm``), trains on
its ``"data"`` rows of each global batch, and rank 0 returns the whole
trees after checking that every rank holds the same.  Weights and
payloads cross as numpy.  Every body checks that its process never
imported JAX."""

from __future__ import annotations

import time

import torch

from kubegpu_tpu_torch.parallel.collectives import gather_objects
from torch_tp_cases import (
    _agreed,
    _jax_free,
    _np,
    _np_opt,
    _synced,
    data_rows,
    flash_counts,
    on_mesh,
    weights,
)


def _state(mesh, spec: dict):
    """This rank's state from ``spec``: ``params`` (whole weights, see
    ``torch_tp_cases.weights``), ``cfg``, ``model`` (``attn_impl``),
    ``optimizer``, ``zero1`` (ZeRO-1, else plain data parallelism),
    ``dtype`` (default float32)."""
    from kubegpu_tpu_torch.models.train import place_lm
    from kubegpu_tpu_torch.models.transformer import TransformerLM
    from kubegpu_tpu_torch.parallel.zero import place_zero1_lm

    _jax_free()
    model = TransformerLM(mesh=mesh, dtype=spec.get("dtype", torch.float32),
                          **spec["cfg"], **spec.get("model", {}))
    params = weights(spec["params"], mesh.device)
    if not spec["zero1"]:
        return place_lm(model, params, optimizer=spec["optimizer"]), None
    return place_zero1_lm(model, params, optimizer=spec["optimizer"])


def _step_fn(mesh, shardings):
    from kubegpu_tpu_torch.models.train import lm_step
    from kubegpu_tpu_torch.parallel.zero import make_zero1_lm_train_step

    return (lm_step if shardings is None
            else make_zero1_lm_train_step(mesh, shardings))


def zero1_run(mesh, spec: dict) -> dict:
    """Steps on each of ``spec["tokens"]`` (ZeRO-1 or plain, see
    :func:`_state`), then with ``spec["dir"]`` a checkpoint there: rank 0
    returns the losses, the whole weights and optimizer state, the step
    and each rank's ``state_bytes_per_device``, by rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        save_checkpoint,
    )
    from kubegpu_tpu_torch.models.train import gather_state
    from kubegpu_tpu_torch.parallel.zero import state_bytes_per_device

    state, sh = _state(mesh, spec)
    step = _step_fn(mesh, sh)
    losses = [step(state, data_rows(mesh, t)).item()
              for t in spec["tokens"]]
    if spec.get("dir"):
        save_checkpoint(make_manager(spec["dir"]), state)
    held = gather_objects(state_bytes_per_device(state), mesh)
    params, opt_state = gather_state(state)
    got = _agreed(mesh, dict(losses=losses, params=_np(params),
                             opt_state=_np_opt(opt_state), step=state.step))
    return None if got is None else dict(got, bytes=held)


def zero1_restore(mesh, spec: dict) -> dict:
    """A fresh state (ZeRO-1 or plain, see :func:`_state`) restored from
    ``spec["dir"]``, one more step on ``spec["tokens"][0]``, gathered
    whole: rank 0 returns the restored trees, the step's loss and the
    trees after it, equal on every rank."""
    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_checkpoint,
    )
    from kubegpu_tpu_torch.models.train import gather_state

    state, sh = _state(mesh, spec)
    restore_checkpoint(make_manager(spec["dir"]), state)
    params, opt_state = gather_state(state)
    restored = dict(params=_np(params), opt_state=_np_opt(opt_state),
                    step=state.step)
    loss = _step_fn(mesh, sh)(state, data_rows(mesh, spec["tokens"][0]))
    params, opt_state = gather_state(state)
    return _agreed(mesh, dict(restored=restored, loss=loss.item(),
                              params=_np(params),
                              opt_state=_np_opt(opt_state)))


def param_sums(model, chunk: int = 1 << 24) -> list:
    """``(name, sum_i w_i p_i, sum_i w_i |p_i|)`` of each parameter in
    float64, ``w_i = 1 + i / n`` over its ``n`` elements in row-major
    order: a checksum that moves when a value, or where it sits, does.
    Taken ``chunk`` elements at a time, so a full-width leaf needs no
    float64 copy of itself."""
    out = []
    for name, p in model.named_parameters():
        flat = p.detach().reshape(-1)
        n, s, a = flat.numel(), 0.0, 0.0
        for i in range(0, n, chunk):
            x = flat[i:i + chunk].double()
            w = torch.arange(i, i + x.numel(), dtype=torch.float64,
                             device=x.device) / n + 1
            s += float((w * x).sum())
            a += float((w * x.abs()).sum())
        out.append((name, s, a))
    return out


def zero1_flagship(mesh, spec: dict) -> list:
    """``spec["steps"]`` steps at a full width (weights drawn on every
    rank from ``spec["params"]``'s seed) on
    ``synthetic_token_batches_for_mesh`` rows, ZeRO-1 or plain: rank 0
    returns, in rank order, each rank's losses, seconds a step, flash
    launches, ``state_bytes_per_device``, the optimizer bytes it really
    holds after the steps (Adam's per-tensor step counts aside), the
    bytes it staged through the host a step, the number of parameters
    cut over ``"data"``, its peak device memory and the
    :func:`param_sums` of its parameters after the last step.
    ``spec["axes"]`` lays the gang's world out as that mesh
    (``torch_tp_cases.on_mesh``).
    The card's memory is given back at the end (a shared gang)."""
    from kubegpu_tpu_torch.models.data import (
        synthetic_token_batches_for_mesh,
    )
    from kubegpu_tpu_torch.models.train import stepped
    from kubegpu_tpu_torch.parallel.collectives import CP_TRAFFIC
    from kubegpu_tpu_torch.parallel.zero import state_bytes_per_device

    mesh = on_mesh(mesh, spec)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state, sh = _state(mesh, spec)
    step = _step_fn(mesh, sh)
    source = synthetic_token_batches_for_mesh(
        spec["batch"], spec["seq"] + 1, spec["cfg"]["vocab_size"], mesh,
        seed=spec.get("seed", 0))
    staged0 = CP_TRAFFIC["host_staged"]
    flash_counts(zero=True)
    losses, seconds = [], []
    for _ in range(spec["steps"]):
        tokens = torch.from_numpy(next(source)).to(dev)
        t0 = _synced(dev)
        losses.append(step(state, tokens).item())
        seconds.append(time.monotonic() - t0)
    launches = flash_counts()
    held_opt = sum(t.numel() * t.element_size()
                   for p in state.model.parameters()
                   for t in state.opt.state[stepped(state, p)].values()
                   if isinstance(t, torch.Tensor) and t.dim())
    mine = dict(losses=losses, seconds=seconds, launches=launches,
                bytes=state_bytes_per_device(state), held_opt=held_opt,
                staged_per_step=(CP_TRAFFIC["host_staged"] - staged0)
                // spec["steps"],
                cut=len(state.zero1),
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None))
    mine["sums"] = param_sums(state.model)
    del state, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None
