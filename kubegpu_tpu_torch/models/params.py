"""The LM weight tree of the port.

The JAX package's ``TransformerLM``, ``DecodeLM`` and ``PagedDecodeLM``
share one flax parameter tree (``layer{i}/attn/q_proj/kernel`` ...).
The port keeps that tree as it is — nested dicts of tensors under the
same names and in the same layouts (dense kernels ``(in, out)``,
embeddings ``(rows, hidden)``, LayerNorm ``scale``/``bias``) — so a flax
tree carries over leaf for leaf and the parity tests hand both packages
the same weights.  Modules are built with parameters on the ``meta``
device and :func:`bind_params` points them at a tree's tensors without a
copy, so the prefill and decode models of one batcher share storage.
A tensor-parallel rank takes the whole tree, JAX's carried over with
:func:`params_from_numpy` too, and cuts its own part
(``parallel.sharding.shard_params``), so both packages serve the same
weights at any width.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

Tree = Dict[str, object]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) needs a card: without one this raises rather than
    fall back, so a run on the CPU is always asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Mapping) -> Tree:
    return {
        k: tree_map(fn, v) if isinstance(v, Mapping) else fn(v)
        for k, v in tree.items()
    }


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: widen exactly, narrow back
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def params_from_numpy(tree: Mapping, device="cpu") -> Tree:
    """A flax parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree of tensors:
    same nesting, names, shapes and dtypes."""
    dev = torch.device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def bf16_cast(tree: Mapping) -> Tree:
    """float32 leaves -> bfloat16, the serving precision; other leaves
    pass through.  The one cast policy of the port (the JAX package's
    ``bf16_cast``)."""
    return tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
        tree,
    )


def init_params(cfg: Mapping, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Tree:
    """Fresh LM weights with the flax tree's shapes and initializer
    families (not its bits): dense kernels lecun-normal (truncated
    normal, std ``1/sqrt(fan_in)``), embeddings normal with std
    ``1/sqrt(hidden)``, LayerNorm scale 1 and bias 0.  ``cfg`` carries
    ``vocab_size, num_layers, hidden, max_seq``.  Each leaf is drawn in
    float32 on ``device`` from ``generator`` (which must live there) and
    then cast to ``dtype``."""
    dev = resolve_device(device)
    vocab, hidden = cfg["vocab_size"], cfg["hidden"]

    def dense(n_in: int, n_out: int) -> Tree:
        # flax lecun_normal: truncated to +-2 std, std corrected by the
        # truncated normal's own std (0.8796...)
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978
        w = torch.empty((n_in, n_out), dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        return {"kernel": w.to(dtype)}

    def embed(rows: int) -> Tree:
        w = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
        w.normal_(0.0, 1.0 / math.sqrt(hidden), generator=generator)
        return {"embedding": w.to(dtype)}

    def norm() -> Tree:
        return {
            "scale": torch.ones((hidden,), dtype=dtype, device=dev),
            "bias": torch.zeros((hidden,), dtype=dtype, device=dev),
        }

    tree: Tree = {"embed": embed(vocab), "pos_embed": embed(cfg["max_seq"])}
    for i in range(cfg["num_layers"]):
        tree[f"layer{i}"] = {
            "ln1": norm(),
            "attn": {
                name: dense(hidden, hidden)
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")
            },
            "ln2": norm(),
            "mlp_up": dense(hidden, 4 * hidden),
            "mlp_down": dense(4 * hidden, hidden),
        }
    tree["ln_f"] = norm()
    tree["lm_head"] = dense(hidden, vocab)
    return tree


def meta_param(*shape: int) -> nn.Parameter:
    """A placeholder parameter on the meta device, bound later."""
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


def bind_params(module: nn.Module, tree: Mapping, *,
                trainable: bool = False) -> nn.Module:
    """Point every parameter of ``module`` at the tensor under the same
    dotted path of ``tree`` — shared storage, no copy.  Raises on a
    missing leaf or a shape that differs from the module's.

    Serving binds frozen parameters (the default).  ``trainable=True``
    binds them with ``requires_grad=True`` for training: every leaf must
    then be float32 (``Dense`` casts it to the compute dtype in the
    forward, so gradients arrive in float32 as flax's do), and an
    optimizer stepping the parameters in place updates the tree."""
    for path, param in list(module.named_parameters()):
        node = tree
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                raise KeyError(f"parameter tree has no leaf {path!r}")
            node = node[part]
        if tuple(node.shape) != tuple(param.shape):
            raise ValueError(
                f"{path}: tree leaf {tuple(node.shape)} != module "
                f"{tuple(param.shape)}"
            )
        if trainable and node.dtype != torch.float32:
            raise ValueError(f"{path}: a trainable leaf must be float32, got "
                             f"{node.dtype}")
        owner = module.get_submodule(path.rpartition(".")[0])
        setattr(owner, path.rpartition(".")[2],
                nn.Parameter(node, requires_grad=trainable))
    return module
