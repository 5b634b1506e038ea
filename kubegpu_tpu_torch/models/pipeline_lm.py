"""Pipeline-parallel decoder LM: the port of
``kubegpu_tpu/models/pipeline_lm.py``.

The same pre-LN decoder as the JAX module, with the layer parameters
stacked ``[S, K, ...]`` (stages x layers a stage) so the block stack
maps onto :func:`~kubegpu_tpu_torch.parallel.pipeline.pipeline_apply`.
The parameters are the JAX module's plain tree, leaf for leaf (same
names, same layouts): ``embed`` ``(vocab, d)``, ``pos`` ``(max_seq,
d)``, ``blocks/{ln1_scale, ln1_bias, ln2_scale, ln2_bias, wq, wk, wv,
wo, w1, w2}`` stacked ``[S, K, ...]`` (or ``[V, P, K, ...]``,
:func:`to_circular_layout`) with kernels ``(in, out)``, ``ln_f_scale``,
``ln_f_bias`` and the float32 ``lm_head`` ``(d, vocab)``; a numpy tree
of the JAX package's loads with ``params.params_from_numpy``.

Its numerics are the JAX module's own, not those of ``TransformerLM``:
LayerNorm with ``eps=1e-5`` and ``var = mean((x - mu)^2)``; the tanh
GELU (``jax.nn.gelu``'s default); scores divided by ``sqrt(hd)`` in the
model dtype, a ``finfo.min`` causal mask, a float32 softmax cast back;
the head count the local q width over ``hd``, so a block runs its TP
shard's heads; a float32 head.  Embeddings, the final LayerNorm and the
head run outside the pipelined region, on every rank (replicated).

Over a ``("pipe",)`` or ``("pipe", "model")`` mesh each rank holds its
stage (or, circular, its V round slices) of every block leaf and, with
a ``model_axis``, its Megatron shard of each kernel (wq/wk/wv/w1
column-parallel, wo/w2 row-parallel, the LayerNorms whole), cut by
:func:`pipeline_rules` (the JAX ``_blocks_tp_specs`` and
``place_pipeline_lm``'s specs); everything else is whole on every rank.
A block's TP collectives are Megatron's *f* on each LayerNorm's output
and *g* on each row-parallel product (JAX's two ``psum``\\ s over
``"model"``), so the LayerNorms, held whole, get the whole gradient on
every ``"model"`` rank.  :class:`PipelineLM` binds a rank's tree as
trainable parameters; :func:`place_pipeline_lm` and
:func:`pipeline_lm_step` train it (the optimizer's moments mirror the
parameters and are cut alike).  Every rank computes the same loss from
the same logits, so a replicated leaf's gradient is the same on every
rank and no gradient is reduced after the backward.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubegpu_tpu_torch.models.params import (
    Tree,
    meta_param,
    resolve_device,
    tree_map,
)
from kubegpu_tpu_torch.models.train import (
    Optimizer,
    TrainState,
    create_train_state,
    cross_entropy,
    place_shards,
    set_opt_state,
)
from kubegpu_tpu_torch.parallel.collectives import (
    copy_to_model,
    reduce_from_model,
)
from kubegpu_tpu_torch.parallel.mesh import PIPE_AXIS
from kubegpu_tpu_torch.parallel.pipeline import (
    check_stage_dims,
    pipeline_apply,
)
from kubegpu_tpu_torch.parallel.sharding import mesh_place, placed_dims

BLOCK_LEAVES = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                "wq", "wk", "wv", "wo", "w1", "w2")
# lecun_normal's truncated normal: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """The JAX module's ``_layer_norm``: ``var = mean((x - mu)^2)``."""
    xc = x - x.mean(-1, keepdim=True)
    var = xc.square().mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def block_apply(p: Mapping, x: torch.Tensor, num_heads: int, mesh=None,
                model_axis: Optional[str] = None) -> torch.Tensor:
    """One pre-LN block: causal attention + gelu MLP, shape-preserving.

    With ``model_axis`` the kernels are this rank's Megatron shards
    (wq/wk/wv/w1 column-parallel, wo/w2 row-parallel) and the block runs
    its collectives over ``mesh``'s ``model_axis``; the head count
    adapts to the local q width."""
    b, s, d = x.shape
    if d % num_heads:
        raise ValueError(f"hidden {d} not divisible by {num_heads} heads")
    hd = d // num_heads
    tp = model_axis is not None
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    if tp:
        y = copy_to_model(y, mesh, model_axis)
    q = y @ p["wq"]
    if q.shape[-1] % hd:
        raise ValueError(
            f"local q width {q.shape[-1]} does not split into whole "
            f"{hd}-wide heads (TP degree must divide {num_heads})")
    heads = q.shape[-1] // hd
    q = q.reshape(b, s, heads, hd)
    k = (y @ p["wk"]).reshape(b, s, heads, hd)
    v = (y @ p["wv"]).reshape(b, s, heads, hd)
    # sqrt(hd) rounded to the model dtype, as JAX divides by it
    scale = float(torch.tensor(math.sqrt(hd), dtype=x.dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores, torch.finfo(x.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s,
                                                             heads * hd)
    out = attn @ p["wo"]
    if tp:
        out = reduce_from_model(out, mesh, model_axis)
    x = x + out
    y = layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    if tp:
        y = copy_to_model(y, mesh, model_axis)
    m = F.gelu(y @ p["w1"], approximate="tanh") @ p["w2"]
    if tp:
        m = reduce_from_model(m, mesh, model_axis)
    return x + m


def stage_apply(stage_params: Mapping, x: torch.Tensor, num_heads: int,
                mesh=None, model_axis: Optional[str] = None) -> torch.Tensor:
    """This stage's K stacked layers (leaves ``[K, ...]``), in order."""
    for i in range(stage_params["ln1_scale"].shape[0]):
        x = block_apply({k: a[i] for k, a in stage_params.items()}, x,
                        num_heads, mesh, model_axis)
    return x


def leaf_shapes(*, vocab_size: int, num_stages: int, layers_per_stage: int,
                hidden: int, mlp_ratio: int = 4, max_seq: int = 2048,
                num_rounds: int = 1) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's whole shape by ``/``-path; with ``num_rounds > 1``
    the blocks in the circular ``[V, P, K, ...]`` layout."""
    d, h = hidden, hidden * mlp_ratio
    lead: Tuple[int, ...] = (num_stages, layers_per_stage)
    if num_rounds > 1:
        lead = (num_rounds, num_stages // num_rounds, layers_per_stage)
    block = {"ln1_scale": (d,), "ln1_bias": (d,), "ln2_scale": (d,),
             "ln2_bias": (d,), "wq": (d, d), "wk": (d, d), "wv": (d, d),
             "wo": (d, d), "w1": (d, h), "w2": (h, d)}
    shapes = {"embed": (vocab_size, d), "pos": (max_seq, d)}
    shapes.update({f"blocks/{k}": lead + block[k] for k in BLOCK_LEAVES})
    shapes.update({"ln_f_scale": (d,), "ln_f_bias": (d,),
                   "lm_head": (d, vocab_size)})
    return shapes


def init_pipeline_lm(generator: torch.Generator, *, vocab_size: int,
                     num_stages: int, layers_per_stage: int, hidden: int,
                     mlp_ratio: int = 4, max_seq: int = 2048,
                     dtype=torch.float32, device="cuda") -> Tree:
    """Fresh weights with the JAX init's tree and distributions (not its
    bits), blocks stacked ``[num_stages, layers_per_stage, ...]``: the
    block kernels lecun-normal (a truncated normal of std
    ``1/sqrt(fan_in)``), ``embed`` and ``pos`` normal with std 0.02,
    LayerNorm scales 1 and biases 0, all in ``dtype``; ``lm_head``
    lecun-normal in float32 whatever ``dtype``.  Each leaf is drawn in
    float32 on ``device`` from ``generator`` (which must live there)."""
    dev = resolve_device(device)
    tree: Tree = {"blocks": {}}
    for path, shape in leaf_shapes(
            vocab_size=vocab_size, num_stages=num_stages,
            layers_per_stage=layers_per_stage, hidden=hidden,
            mlp_ratio=mlp_ratio, max_seq=max_seq).items():
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        name = path.rpartition("/")[2]
        if name.endswith("scale"):
            w.fill_(1.0)
        elif name.endswith("bias"):
            w.zero_()
        elif name in ("embed", "pos"):
            w.normal_(0.0, 0.02, generator=generator)
        else:
            std = math.sqrt(1.0 / shape[-2]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        if name != "lm_head":
            w = w.to(dtype)
        if path.startswith("blocks/"):
            tree["blocks"][name] = w
        else:
            tree[path] = w
    return tree


def to_circular_layout(params: Mapping, num_devices: int) -> Tree:
    """Re-stack blocks ``[S_total, K, ...]`` -> ``[V, P, K, ...]`` for the
    circular schedule: global stage ``s = v*P + p`` lands at ``[v, p]``,
    so a row-major flatten restores stage order."""
    s_total = params["blocks"]["ln1_scale"].shape[0]
    if s_total % num_devices:
        raise ValueError(
            f"{s_total} stages do not split over {num_devices} devices")
    out = dict(params)
    out["blocks"] = {k: a.reshape((s_total // num_devices, num_devices)
                                  + tuple(a.shape[1:]))
                     for k, a in params["blocks"].items()}
    return out


def blocks_tp_specs(axis: str = PIPE_AXIS,
                    model_axis: str = "model") -> Dict[str, Dict[str, int]]:
    """The ``{axis: dim}`` cut of each ``[S, K, ...]`` block leaf on a
    (pipe, model) mesh (the JAX ``_blocks_tp_specs``): the stage dim
    over ``axis``; column-parallel kernels their output dim, row-parallel
    their input dim over ``model_axis``; the LayerNorms whole over
    ``model_axis``."""
    col = {axis: 0, model_axis: 3}
    row = {axis: 0, model_axis: 2}
    vec = {axis: 0}
    return {"ln1_scale": vec, "ln1_bias": vec, "ln2_scale": vec,
            "ln2_bias": vec, "wq": col, "wk": col, "wv": col, "wo": row,
            "w1": col, "w2": row}


def pipeline_rules(num_rounds: int = 1, axis: str = PIPE_AXIS,
                   model_axis: Optional[str] = None) -> tuple:
    """The sharding rules (``parallel.sharding``'s) of the tree on a
    pipeline mesh: the block leaves' stage dim over ``axis`` (dim 0 of
    ``[S, K, ...]``, dim 1 of the circular ``[V, P, K, ...]``), with a
    ``model_axis`` :func:`blocks_tp_specs`; every other leaf whole."""
    if model_axis is not None:
        if num_rounds > 1:
            raise ValueError("PP x TP composes with the GPipe schedule only")
        return tuple((f"blocks/{k}$", spec) for k, spec in
                     blocks_tp_specs(axis, model_axis).items())
    return (("blocks/", {axis: 1 if num_rounds > 1 else 0}),)


def head(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm and the float32 head (the JAX ``_head``)."""
    x = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])
    return x.float() @ params["lm_head"]


def _embed(params: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    t = tokens.shape[1]
    return params["embed"][tokens.long()] + params["pos"][:t][None]


def pipeline_lm_logits(params: Mapping, tokens: torch.Tensor, mesh, *,
                       num_heads: int, num_microbatches: int,
                       axis: str = PIPE_AXIS, num_rounds: int = 1,
                       model_axis: Optional[str] = None) -> torch.Tensor:
    """Forward through the pipelined block stack: float32 logits ``(b,
    t, vocab)`` on every rank.  ``params`` is this rank's tree (its
    stage's block leaves, ``[1, K, ...]`` or circular ``[V, 1, K,
    ...]``; ``mesh`` None: one device, the whole tree); the batch must
    divide into ``num_microbatches``.  ``model_axis`` composes PP with
    Megatron TP on a (pipe, model) mesh (GPipe only)."""
    if model_axis is not None and num_rounds > 1:
        raise ValueError("PP x TP composes with the GPipe schedule only")
    b, t = tokens.shape
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         "microbatches")
    x = _embed(params, tokens)
    stream = x.reshape((num_microbatches, b // num_microbatches)
                       + tuple(x.shape[1:]))
    run = pipeline_apply(partial(stage_apply, num_heads=num_heads,
                                 mesh=mesh, model_axis=model_axis),
                         mesh, axis, num_rounds=num_rounds)
    out = run(params["blocks"], stream)
    return head(params, out.reshape(b, t, -1))


def sequential_lm_logits(params: Mapping, tokens: torch.Tensor, *,
                         num_heads: int) -> torch.Tensor:
    """The same math with no pipelining (the correctness oracle), on the
    whole tree: the stage dims flattened (row-major restores the global
    stage order in both layouts) and every layer run in order on the
    whole batch."""
    lead = params["blocks"]["ln1_scale"].ndim - 1
    flat = {k: a.reshape((-1,) + tuple(a.shape[lead:]))
            for k, a in params["blocks"].items()}
    return head(params, stage_apply(flat, _embed(params, tokens),
                                    num_heads))


class PipelineLM(nn.Module):
    """This rank's part of the pipelined LM as a module: the tree's
    leaves as parameters under their paths (``blocks.wq`` ...), cut by
    :func:`pipeline_rules` over ``mesh`` (None: one device, the whole
    tree), bound by :func:`place_pipeline_lm`.  ``num_stages`` is the
    global stage count, ``mesh[axis]`` x ``num_rounds``; the forward
    returns the float32 logits of :func:`pipeline_lm_logits`, the same
    on every rank."""

    def __init__(self, *, vocab_size: int, num_stages: int,
                 layers_per_stage: int, hidden: int, num_heads: int,
                 num_microbatches: int, mlp_ratio: int = 4,
                 max_seq: int = 2048, num_rounds: int = 1, mesh=None,
                 axis: str = PIPE_AXIS,
                 model_axis: Optional[str] = None) -> None:
        super().__init__()
        devices = 1 if mesh is None else mesh.axis_size(axis)
        if num_stages != devices * num_rounds:
            raise ValueError(
                f"{num_stages} stages are not {num_rounds} round(s) over "
                f"the {devices} devices of axis {axis!r}")
        self.shard_rules = pipeline_rules(num_rounds, axis, model_axis)
        self.mesh, self.axis, self.model_axis = mesh, axis, model_axis
        self.devices, self.num_rounds = devices, num_rounds
        self.num_heads, self.num_microbatches = num_heads, num_microbatches
        self.blocks = nn.Module()
        place = mesh_place(mesh)
        for path, shape in leaf_shapes(
                vocab_size=vocab_size, num_stages=num_stages,
                layers_per_stage=layers_per_stage, hidden=hidden,
                mlp_ratio=mlp_ratio, max_seq=max_seq,
                num_rounds=num_rounds).items():
            local = list(shape)
            for a, dim in placed_dims(path, len(shape), place,
                                      self.shard_rules).items():
                local[dim] //= place[a][1]
            owner, _, name = path.rpartition("/")
            (self.blocks if owner else self).register_parameter(
                name, meta_param(*local))

    def tree(self) -> Tree:
        out: Tree = {"blocks": {k: getattr(self.blocks, k)
                                for k in BLOCK_LEAVES}}
        for k in ("embed", "pos", "ln_f_scale", "ln_f_bias", "lm_head"):
            out[k] = getattr(self, k)
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return pipeline_lm_logits(
            self.tree(), tokens, self.mesh, num_heads=self.num_heads,
            num_microbatches=self.num_microbatches, axis=self.axis,
            num_rounds=self.num_rounds, model_axis=self.model_axis)


def place_pipeline_lm(model: PipelineLM, params: Mapping, *,
                      opt_state: Optional[Mapping] = None,
                      optimizer: Optional[Optimizer] = None,
                      step: int = 0) -> TrainState:
    """The JAX ``place_pipeline_lm``: ``model``'s train state from WHOLE
    trees of tensors (``params``, and optionally the optimizer state in
    optax's layout, whose moments mirror the parameters): this rank
    keeps its stage (or round slices) of every block leaf and, under PP
    x TP, its Megatron shard of each kernel, copied onto the mesh's
    device; every other leaf whole.  At one device (no mesh) the state
    holds copies of the trees on their device.  Refuses stacks that do
    not lead with the mesh's ``[P]`` (GPipe) or ``[V, P]`` (circular), as
    JAX does."""
    check_stage_dims(params["blocks"], model.devices, model.num_rounds,
                     model.axis)
    if model.mesh is None:
        state = create_train_state(model, tree_map(torch.clone, params),
                                   optimizer=optimizer, step=step)
        if opt_state is not None:
            set_opt_state(state, opt_state)
        return state
    return place_shards(model, params, opt_state, optimizer, step,
                        model.mesh, model.shard_rules)


def pipeline_lm_loss(model: PipelineLM, tokens: torch.Tensor) -> torch.Tensor:
    """The next-token loss of a ``(b, s + 1)`` token window, the mean
    over every token (JAX's ``cross_entropy``), the same on every rank:
    the head is replicated, so no mesh reaches the loss."""
    return cross_entropy(model(tokens[:, :-1]), tokens[:, 1:])


def pipeline_lm_grads(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """The step's loss and this rank's gradients, without the update."""
    state.opt.zero_grad(set_to_none=True)
    loss = pipeline_lm_loss(state.model, tokens)
    loss.backward()
    return loss.detach()


def pipeline_lm_step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """One training step, the JAX ``make_pipeline_lm_train_step``'s:
    loss, gradients, one update of the optimizer on this rank's leaves.
    Returns the loss as a 0-d tensor on the device."""
    loss = pipeline_lm_grads(state, tokens)
    state.opt.step()
    state.step += 1
    return loss
