#!/usr/bin/env python3
"""Convert the JAX package's Orbax training checkpoints into the
PyTorch port's format (``kubegpu_tpu_torch/models/checkpoint.py``).

    python tools/orbax_to_torch_checkpoint.py --src JAX_CKPT_DIR \\
        --dst PORT_CKPT_DIR

``--src`` is the ``--ckpt-dir`` the JAX worker was given; the worker
namespaces its checkpoints by ``--model``.  For each of ``lm``,
``moe``, ``resnet50``, ``resnet50-unrolled`` and ``resnet-tiny`` found
under ``--src``, its latest step
``<src>/<model>/<step>`` is read and written as ``<dst>/<model>/<step>``,
so the port's worker takes ``--ckpt-dir PORT_CKPT_DIR`` to resume it
(``--model lm``, ``moe`` or a ResNet) or serve it (``--model
decode``).  What is
carried: the parameters, a ResNet's BatchNorm statistics
(``batch_stats``), the optimizer state in optax's layout (SGD's
``TraceState.trace``; Adam's ``mu``, ``nu`` and ``count``) and the
step.  Orbax restores the tree without a template here: its own
metadata gives every leaf's shape and dtype, and the arrays are read
onto one host device whatever mesh wrote them.

The Orbax checkpoint holds no hyperparameters, and its shapes give
neither the LM's head count nor a ResNet's image size, nor a MoE
model's router, dispatch or capacity factor: the record names the
optimizer (SGD's trace or Adam's moments), and its learning rate, the
heads, the image size and those three are null.

Needs JAX and Orbax (the JAX package's environment); the port itself
never imports this script.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterator, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def read_orbax(step_dir: str) -> dict:
    """The saved tree of one Orbax step (``<root>/<step>``) as numpy,
    restored without a template onto one host device."""
    import jax
    import orbax.checkpoint as ocp

    item = os.path.join(step_dir, "default")
    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(item)
    tree = getattr(meta, "item_metadata", meta)
    one = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=one), tree)
    return jax.tree.map(np.asarray, ckptr.restore(item, abstract))


def flat(tree, prefix: str) -> Iterator[Tuple[str, np.ndarray]]:
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, np.asarray(v)


def optimizer_of(opt_state) -> Tuple[dict, Dict[str, object]]:
    """(the port's optimizer record, optax's first state as a dict) of
    the saved ``opt_state``: ``[TraceState, EmptyState]`` for SGD,
    ``[ScaleByAdamState, EmptyState]`` for Adam."""
    first = opt_state[0] if isinstance(opt_state, (list, tuple)) else None
    if isinstance(first, dict) and set(first) == {"trace"}:
        return dict(name="sgd", lr=None), first
    if isinstance(first, dict) and set(first) == {"count", "mu", "nu"}:
        return dict(name="adam", lr=None), first
    raise ValueError("optimizer state is neither optax SGD's trace nor "
                     f"Adam's (count, mu, nu): {type(first)} "
                     f"{sorted(first) if isinstance(first, dict) else ''}")


MODELS = ("lm", "moe", "resnet50", "resnet50-unrolled", "resnet-tiny")


def model_dims(params: dict) -> dict:
    """The dims the port's record holds, from the parameter shapes: the
    LM's widths (a MoE model's with its experts), or a ResNet's layout,
    stages, filters and classes."""
    if "conv_init" in params:
        stages: dict = {}
        for name, sub in params.items():
            stage, _, part = name.partition("_")
            if stage.startswith("stage"):
                i = int(stage[len("stage"):])
                n = (np.shape(sub["block"]["conv1"]["kernel"])[0]
                     if part == "body" else 1)
                stages[i] = stages.get(i, 0) + int(n)
        scan = any(k.endswith("_body") or k.endswith("_head")
                   for k in params)
        return dict(family="resnet", layout="scan" if scan else "unrolled",
                    stage_sizes=[stages[i] for i in sorted(stages)],
                    num_filters=int(params["conv_init"]["kernel"].shape[-1]),
                    num_classes=int(params["head"]["kernel"].shape[1]),
                    image_size=None)
    vocab, hidden = params["embed"]["embedding"].shape
    dims = dict(vocab_size=int(vocab), hidden=int(hidden),
                max_seq=int(params["pos_embed"]["embedding"].shape[0]),
                num_layers=sum(1 for k in params if k.startswith("layer")),
                num_heads=None)
    moe = params.get("layer0", {}).get("moe_mlp")
    if moe is not None:
        e, d, h = np.shape(moe["w_up"])
        dims.update(family="moe", num_experts=int(e),
                    mlp_ratio=int(h) // int(d), capacity_factor=None,
                    router_type=None, dispatch_impl=None)
    return dims


def convert(src: str, dst: str, model: str = "lm") -> str:
    """Convert the latest ``<src>/<model>/<step>`` into
    ``<dst>/<model>/<step>``; returns the written directory."""
    import orbax.checkpoint as ocp

    from kubegpu_tpu_torch.models.checkpoint import make_manager

    root = os.path.join(os.path.abspath(src), model)
    step = ocp.CheckpointManager(root).latest_step()
    if step is None:
        raise SystemExit(f"no Orbax checkpoint under {root}")
    tree = read_orbax(os.path.join(root, str(step)))
    saved_step = int(tree["step"])
    if saved_step != step:
        raise SystemExit(f"{root}/{step} holds step {saved_step}")
    record, opt = optimizer_of(tree["opt_state"])
    params = tree["params"]
    stats = list(flat(tree.get("batch_stats") or {}, "batch_stats"))

    def leaves():
        yield from flat(params, "params")
        for name in sorted(opt):
            if isinstance(opt[name], dict):
                yield from flat(opt[name], f"opt_state/{name}")
            else:
                yield f"opt_state/{name}", np.asarray(opt[name], np.int32)
        yield from stats
        yield "step", np.asarray(saved_step, np.int32)

    return make_manager(os.path.join(os.path.abspath(dst), model)).write(
        saved_step, leaves(), dict(
            optimizer=record, model=model_dims(params),
            batch_stats=[k for k, _ in stats],
            converted_from=os.path.join(root, str(step))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the JAX worker's --ckpt-dir")
    ap.add_argument("--dst", required=True,
                    help="the port's --ckpt-dir to write into")
    args = ap.parse_args(argv)
    models = [m for m in MODELS if os.path.isdir(
        os.path.join(os.path.abspath(args.src), m))]
    if not models:
        raise SystemExit(f"no checkpoint of {', '.join(MODELS)} under "
                         f"{args.src}")
    for model in models:
        print(f"CONVERTED {convert(args.src, args.dst, model)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
