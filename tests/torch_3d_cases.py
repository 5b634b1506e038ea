"""Rank bodies of data x tensor x context-parallel LM training over a
``("data", "model", "seq")`` mesh: the CPU tests
(``tests/test_torch_3d_train.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang as ``fn(mesh, spec)``; with
``spec["axes"]`` it first lays the gang's world out as that mesh
(``torch_tp_cases.on_mesh``: new groups over the same ranks), so one
gang of eight processes runs every 8-rank mesh.  Every rank builds the
context-parallel model over the mesh, keeps its Megatron shard of the
whole weights (``torch_cp_cases._cp_state``, which places a 3-D state
with ``train.place_lm``), trains on its ``"data"`` rows of each global
batch (``train.lm_loss`` cuts its ``"seq"`` window), and rank 0 returns
the whole trees (gathered over ``"model"``), after checking that every
rank holds the same.  Weights and payloads cross as numpy.  Every body
checks that its process never imported JAX.  The full-width 3-D step
is ``torch_cp_cases.cp_flagship``."""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.parallel.collectives import gather_objects
from torch_cp_cases import _cp_state as _state
from torch_tp_cases import (
    _agreed,
    _jax_free,
    _np,
    _np_opt,
    data_rows,
    flash_counts,
    on_mesh,
)


def _coords(mesh) -> tuple:
    return tuple(mesh.coord(a) for a in ("data", "model", "seq"))


def grads_3d(mesh, spec: dict) -> dict:
    """One step's loss and gradients, no update (``lm_grads``), on
    ``spec["tokens"][0]``: rank 0 returns the loss, every gradient leaf
    whole, whether the heads were replicated over ``"model"``, and each
    rank's flash launches and ``(data, model, seq)`` coordinates, by
    rank."""
    from kubegpu_tpu_torch.models.train import grad_tree, lm_grads
    from kubegpu_tpu_torch.parallel.sharding import gather_params

    mesh = on_mesh(mesh, spec)
    state = _state(mesh, spec)
    flash_counts(zero=True)
    loss = lm_grads(state, data_rows(mesh, spec["tokens"][0]))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    every = gather_objects((flash_counts(), _coords(mesh)), mesh)
    attn = state.model.blocks()[0].attn
    got = _agreed(mesh, dict(
        loss=loss.item(), grads=_np(gather_params(grad_tree(state), mesh)),
        heads_replicated=attn.heads_mesh is not None))
    return None if got is None else dict(
        got, launches=[e[0] for e in every], coords=[e[1] for e in every])


def steps_3d(mesh, spec: dict) -> dict:
    """``lm_step`` on each of ``spec["tokens"]``: rank 0 returns the
    losses, the whole weights and optimizer state after the last step
    and the step count, equal on every rank."""
    from kubegpu_tpu_torch.models.train import gather_state, lm_step

    mesh = on_mesh(mesh, spec)
    state = _state(mesh, spec)
    losses = [lm_step(state, data_rows(mesh, t)).item()
              for t in spec["tokens"]]
    params, opt_state = gather_state(state)
    return _agreed(mesh, dict(losses=losses, params=_np(params),
                              opt_state=_np_opt(opt_state),
                              step=state.step))


def layout_3d(mesh, spec: dict) -> list:
    """This rank's ``(data, model, seq)`` coordinates and the ranks of
    its ``"data"``, ``"model"`` and ``"seq"`` lines and of its
    ``"data"`` x ``"seq"`` plane: rank 0 returns every rank's, in rank
    order."""
    import torch.distributed as dist

    from kubegpu_tpu_torch.parallel.mesh import DATA_SEQ

    _jax_free()
    mesh = on_mesh(mesh, spec)
    groups = {"+".join(a) if isinstance(a, tuple) else a:
              dist.get_process_group_ranks(mesh.axis_group(a))
              for a in ("data", "model", "seq", DATA_SEQ)}
    every = gather_objects(dict(coords=_coords(mesh), groups=groups), mesh)
    return every if mesh.rank == 0 else None


def collectives_3d(mesh, spec: dict) -> list:
    """``data_seq_mean`` and ``gather_axis`` over ``"model"`` along the
    last dim, forward and backward, on this rank's ``(2, 3, 4)`` float64
    input filled from the rank number, each backward fed a
    rank-dependent upstream: rank 0 returns every rank's, in rank
    order."""
    from kubegpu_tpu_torch.parallel import collectives as c

    _jax_free()
    mesh = on_mesh(mesh, spec)
    x_in = (torch.arange(24, dtype=torch.float64).reshape(2, 3, 4)
            + 1000.0 * mesh.rank)
    out = {}
    for name, fn in (("data_seq_mean", c.data_seq_mean),
                     ("gather_model", lambda x, m: c.gather_axis(
                         x, m, "model", dim=-1))):
        x = x_in.clone().requires_grad_()
        y = fn(x, mesh)
        y.backward(torch.ones_like(y) * (mesh.rank + 1))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    every = gather_objects(out, mesh)
    return every if mesh.rank == 0 else None
