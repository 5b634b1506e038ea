"""LM training at one device: the port of ``kubegpu_tpu/models/train.py``'s
``TrainState``, ``cross_entropy``, ``lm_loss`` and ``make_lm_train_step``.

The optimizer is the JAX package's default, ``optax.sgd(0.1,
momentum=0.9, nesterov=True)``, as ``torch.optim.SGD(lr=0.1,
momentum=0.9, nesterov=True)``.  The two compute the same update.  optax
chains ``trace(decay=0.9, nesterov=True)`` with a scale by ``-lr``: from
the trace ``t`` (zeros at init) and the gradient ``g`` it takes
``t' = g + 0.9 t`` and the update ``-0.1 (g + 0.9 t')``.  torch's SGD
keeps ``momentum_buffer`` ``b``: ``b' = 0.9 b + g`` (on its first step
``b' = g``, which is ``0.9 * 0 + g``), then with nesterov
``p' = p - 0.1 (g + 0.9 b')``.  So ``b`` is ``t`` step for step, and a
state carried across with ``momentum_buffer = trace``
(:func:`train_state_from_numpy`) continues identically.

Parameters are float32 leaves bound to the model with
``requires_grad=True``; the optimizer steps them in place, so the state's
tree is always the current weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
from torch import nn

from kubegpu_tpu_torch.models.params import (
    Tree,
    bind_params,
    params_from_numpy,
    resolve_device,
)

LEARNING_RATE = 0.1
MOMENTUM = 0.9


@dataclass
class TrainState:
    """The model bound to its float32 tree, the optimizer over it, and
    the number of steps taken (the JAX ``TrainState.step``)."""

    model: nn.Module
    params: Tree
    opt: torch.optim.SGD
    step: int = 0


def create_train_state(model: nn.Module, params: Tree, *,
                       step: int = 0) -> TrainState:
    """Bind ``params`` (float32 leaves, on the device to train on) to
    ``model`` as trainable parameters and build nesterov SGD over them
    with an empty momentum (optax's zero trace)."""
    bind_params(model, params, trainable=True)
    opt = torch.optim.SGD(model.parameters(), lr=LEARNING_RATE,
                          momentum=MOMENTUM, nesterov=True)
    return TrainState(model=model, params=params, opt=opt, step=step)


def train_state_from_numpy(model: nn.Module, params: Mapping,
                           trace: Optional[Mapping] = None, *, step: int = 0,
                           device="cuda") -> TrainState:
    """A JAX train state carried across: ``params`` is the flax tree and
    ``trace`` optax's momentum trace (``opt_state[0].trace``), both as
    numpy (``jax.tree.map(np.asarray, ...)``).  SGD's ``momentum_buffer``
    of each parameter is set to its trace leaf, so a state taken mid-
    training continues as the JAX step would."""
    dev = resolve_device(device)
    state = create_train_state(model, params_from_numpy(params, dev),
                               step=step)
    if trace is not None:
        trace_t = params_from_numpy(trace, dev)
        for path, param in model.named_parameters():
            node = trace_t
            for part in path.split("."):
                node = node[part]
            state.opt.state[param]["momentum_buffer"] = node.float().clone()
    return state


def momentum_tree(state: TrainState) -> Tree:
    """SGD's momentum buffers in the parameter tree's layout (the optax
    trace's counterpart); zeros before the first step."""
    tree: Tree = {}
    for path, param in state.model.named_parameters():
        buf = state.opt.state.get(param, {}).get("momentum_buffer")
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = (torch.zeros_like(param) if buf is None
                           else buf.detach())
    return tree


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` (the
    JAX ``cross_entropy``: log-softmax, take, mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def lm_loss(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss of a ``(b, s + 1)`` token window: the model reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``."""
    return cross_entropy(model(tokens[:, :-1]), tokens[:, 1:])


def lm_step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """One training step, the JAX ``make_lm_train_step``'s: loss,
    gradients, one nesterov-SGD update in place.  Returns the step's
    loss as a 0-d tensor on the device (no host sync)."""
    state.opt.zero_grad(set_to_none=True)
    loss = lm_loss(state.model, tokens)
    loss.backward()
    state.opt.step()
    state.step += 1
    return loss.detach()
