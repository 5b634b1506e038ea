"""Rank bodies of context-parallel attention and training: the CPU tests
(``tests/test_torch_cp_*.py``), the card tests
(``tests/test_torch_cuda_cp_train.py``) and ``chip_smoke.py``.

Each function runs on every rank of a gang whose mesh has a ``"seq"``
axis (``kubegpu_tpu_torch.parallel.launch.Gang``) as ``fn(mesh,
*args)``.  Attention: each rank takes its ``"seq"`` coordinate's rows of
global q, k, v and dO, runs the forward and the backward, and rank 0
returns the rows of every rank joined back into global arrays.
Training: every rank builds the context-parallel model over the mesh
with the whole weights, trains on its data rows of each global batch
(``train.lm_loss`` cuts its ``"seq"`` window) and rank 0 returns the
trees, after checking every rank's equal to its own.  Weights and
payloads cross as numpy.  Every body checks that its process never
imported JAX."""

from __future__ import annotations

import time

import numpy as np
import torch

from kubegpu_tpu_torch.parallel.collectives import CP_TRAFFIC, gather_objects
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

def seq_rows(mesh, x: np.ndarray, dim: int = 1) -> np.ndarray:
    """This rank's ``"seq"`` coordinate's slice of ``x`` along ``dim``."""
    cp, i = mesh.axis_size("seq"), mesh.coord("seq")
    n = x.shape[dim] // cp
    return np.take(x, np.arange(i * n, (i + 1) * n), axis=dim)


def _joined(mesh, mine: dict) -> dict:
    """Every rank's arrays in ``mine`` joined along the sequence (dim 1)
    in ``"seq"`` order, from the ranks of data row 0; other entries as
    rank 0 has them, ``launches`` and ``traffic`` as a list by rank."""
    every = gather_objects(mine, mesh)
    if mesh.rank != 0:
        return None
    row0 = [e for e in every if e["coords"][0] == 0]
    row0.sort(key=lambda e: e["coords"][1])
    out = {}
    for k, v in every[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate([e[k] for e in row0], axis=1)
        elif k in ("launches", "traffic", "coords"):
            out[k] = [e[k] for e in every]
        else:
            out[k] = v
    return out


def attention(mesh, spec: dict) -> dict:
    """``spec``: global float32 numpy ``q``, ``k``, ``v``, ``dout``
    ``(b, s, h, d)``, ``impl`` (``"ring"``, ``"ring-einsum"``,
    ``"ulysses"``, ``"ulysses-reference"``) and ``causal``.  Each rank
    runs its rows forward and backward on its device; rank 0 returns
    ``out``, ``dq``, ``dk``, ``dv`` joined whole and every rank's flash
    launches and ``CP_TRAFFIC`` bytes."""
    from kubegpu_tpu_torch.ops.attention import (
        ring_attention,
        ulysses_attention,
    )

    _jax_free()
    dev = mesh.device

    def mine(name):
        return torch.from_numpy(np.ascontiguousarray(
            seq_rows(mesh, spec[name]))).to(dev)

    q, k, v = (mine(n).requires_grad_() for n in ("q", "k", "v"))
    dout = mine("dout")
    impl, causal = spec["impl"], spec["causal"]
    flash_counts(zero=True)
    traffic0 = dict(CP_TRAFFIC)
    if impl.startswith("ring"):
        out = ring_attention(q, k, v, mesh, causal,
                             impl="einsum" if impl == "ring-einsum"
                             else "flash")
    else:
        out = ulysses_attention(q, k, v, mesh, causal,
                                use_flash=impl == "ulysses")
    out.backward(dout)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = {n: t.detach().cpu().numpy()
           for n, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad))}
    res.update(launches=flash_counts(),
               traffic={k: v - traffic0[k] for k, v in CP_TRAFFIC.items()},
               coords=(mesh.coord("data"), mesh.coord("seq")))
    return _joined(mesh, res)


def _cp_state(mesh, spec: dict):
    """This rank's context-parallel train state from ``spec``:
    ``params`` (whole weights, see ``torch_tp_cases.weights``), optional
    ``trace`` (the whole momentum as numpy), ``optimizer``, ``step``,
    ``cfg`` (the model's widths), ``model`` (``attn_impl``, ``remat``),
    ``dtype`` (the compute type, default float32).  On a mesh with a
    ``"model"`` axis too (the 3-D mesh) the rank keeps its Megatron
    shards (``place_lm``), else the whole trees (``place_cp_lm``)."""
    from kubegpu_tpu_torch.models.train import place_cp_lm, place_lm
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    _jax_free()
    model = TransformerLM(mesh=mesh, dtype=spec.get("dtype", torch.float32),
                          context_parallel=True, **spec["cfg"],
                          **spec.get("model", {}))
    trace = spec.get("trace")
    place = place_lm if "model" in mesh.axis_names else place_cp_lm
    return place(model, weights(spec["params"], mesh.device),
                 opt_state=(None if trace is None else
                            {"trace": weights(trace, mesh.device)}),
                 optimizer=spec.get("optimizer"), step=spec.get("step", 0))


def cp_grads(mesh, spec: dict) -> dict:
    """One step's loss and gradients, no update (``lm_grads``), on
    ``spec["tokens"][0]``: rank 0 returns the loss and every gradient
    leaf (equal on every rank) and each rank's flash launches, by
    rank.  ``spec["axes"]`` lays the gang's world out as that mesh
    (``torch_tp_cases.on_mesh``)."""
    from kubegpu_tpu_torch.models.train import grad_tree, lm_grads

    mesh = on_mesh(mesh, spec)
    state = _cp_state(mesh, spec)
    flash_counts(zero=True)
    loss = lm_grads(state, data_rows(mesh, spec["tokens"][0]))
    launches = gather_objects(flash_counts(), mesh)
    got = _agreed(mesh, dict(loss=loss.item(), grads=_np(grad_tree(state))))
    return None if got is None else dict(got, launches=launches)


def cp_steps(mesh, spec: dict) -> dict:
    """``lm_step`` on each of ``spec["tokens"]``: rank 0 returns the
    losses, the weights and the optimizer state after the last step and
    the step count, equal on every rank."""
    from kubegpu_tpu_torch.models.train import gather_state, lm_step

    state = _cp_state(mesh, spec)
    losses = [lm_step(state, data_rows(mesh, t)).item()
              for t in spec["tokens"]]
    params, opt_state = gather_state(state)
    return _agreed(mesh, dict(losses=losses, params=_np(params),
                              opt_state=_np_opt(opt_state),
                              step=state.step))


def cp_flagship(mesh, spec: dict) -> dict:
    """``spec["steps"]`` steps at a full width (weights drawn on every
    rank from ``spec["params"]``'s seed; on a 3-D mesh each rank keeps its
    shards) on ``synthetic_token_batches_for_mesh`` rows, then this
    rank's numbers:
    rank 0 returns, in rank order, each rank's losses, seconds a step,
    flash launches, bytes sent along ``"seq"`` a step, peak device
    memory and coordinates, and unless ``spec["parts"]`` is False the
    seconds of one more step's parts (``parts``: forward and backward,
    ``sync_grads``, the optimizer), timed after the counts are read."""
    from kubegpu_tpu_torch.models.data import (
        synthetic_token_batches_for_mesh,
    )
    from kubegpu_tpu_torch.models.train import lm_loss, lm_step, sync_grads

    mesh = on_mesh(mesh, spec)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = _cp_state(mesh, spec)
    cfg = spec["cfg"]
    source = synthetic_token_batches_for_mesh(
        spec["batch"], spec["seq"] + 1, cfg["vocab_size"], mesh,
        seed=spec.get("seed", 0))
    flash_counts(zero=True)
    traffic0 = dict(CP_TRAFFIC)
    losses, seconds = [], []
    for _ in range(spec["steps"]):
        tokens = torch.from_numpy(next(source)).to(dev)
        t0 = time.monotonic()
        losses.append(lm_step(state, tokens).item())
        seconds.append(time.monotonic() - t0)
    launches = flash_counts()
    traffic = {k: (v - traffic0[k]) // spec["steps"]
               for k, v in CP_TRAFFIC.items()}
    parts = None
    if spec.get("parts", True):
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
    mine = dict(losses=losses, seconds=seconds, launches=launches,
                traffic_per_step=traffic, parts=parts,
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
                coords=(mesh.coord("data"), mesh.coord("seq")))
    # the card's memory back for the next call in a shared gang
    del state, tokens
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None


def cp_collectives(mesh) -> list:
    """The "seq" collectives' forwards and backwards on this rank's
    ``(2, 4, 4, 3)`` float64 input filled from the rank number, each
    backward fed a rank-dependent upstream, and the ranks of this rank's
    ``"seq"`` group: rank 0 returns every rank's, in rank order."""
    import torch.distributed as dist

    from kubegpu_tpu_torch.parallel import collectives as c

    _jax_free()
    x_in = (torch.arange(2 * 4 * 4 * 3, dtype=torch.float64)
            .reshape(2, 4, 4, 3) + 1000.0 * mesh.rank)
    out = {"groups": {"seq": dist.get_process_group_ranks(
        mesh.axis_group("seq"))}}
    for name, fn in (("ring_shift", c.ring_shift),
                     ("seq_to_heads", c.seq_to_heads),
                     ("gather_axis", c.gather_axis),
                     ("mesh_mean", c.mesh_mean)):
        x = x_in.clone().requires_grad_()
        y = fn(x, mesh)
        y.backward(torch.ones_like(y) * (mesh.rank + 1))
        out[name] = (y.detach().numpy(), x.grad.numpy())
    out["round_trip"] = c.heads_to_seq(c.seq_to_heads(x_in, mesh),
                                       mesh).numpy()
    out["ring_shift_pair"] = [t.numpy() for t in
                              c.ring_shift([x_in, 2 * x_in], mesh)]
    every = gather_objects(out, mesh)
    return every if mesh.rank == 0 else None


def mesh_layout(mesh) -> list:
    """This rank's coordinates, ``cp_size`` and the ranks of its
    ``"data"`` and ``"seq"`` groups: rank 0 returns every rank's, in rank
    order."""
    import torch.distributed as dist

    from kubegpu_tpu_torch.parallel.mesh import cp_size, tp_size

    mine = dict(coords=(mesh.coord("data"), mesh.coord("seq")),
                sizes=(cp_size(mesh), tp_size(mesh)),
                groups={a: dist.get_process_group_ranks(mesh.axis_group(a))
                        for a in ("data", "seq")})
    every = gather_objects(mine, mesh)
    return every if mesh.rank == 0 else None
