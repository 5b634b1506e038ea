"""Rank bodies of the ResNet's data-parallel cases, shared by the CPU
tests and the card smoke: a JAX-free module, so a gang's spawned ranks
import it without JAX (the card machine has none).

A case gets whole numpy trees and the global batches, builds the model
over its ``{"data": n}`` mesh (``mesh`` None: one device), keeps its own
rows of every batch and returns numpy results from rank 0: the losses,
the first step's gradients (read before the optimizer, whose CUDA
multi-tensor nesterov SGD writes the momentum into them) and new
statistics, and the final parameters, optimizer state and
statistics."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from kubegpu_tpu_torch.models.data import synthetic_image_batches
from kubegpu_tpu_torch.models.params import (
    init_resnet_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.models.resnet import ResNet, ScanResNet
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    grad_tree,
    opt_state_tree,
    place_resnet,
    resnet_grads,
    resnet_loss,
    sgd,
    sync_grads,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_model(cfg: dict, mesh=None):
    """The ResNet of ``cfg`` (``layout`` "unrolled" or "scan",
    ``stage_sizes``, ``num_filters``, ``num_classes``, ``dtype`` by
    name) over ``mesh``."""
    cls = ScanResNet if cfg["layout"] == "scan" else ResNet
    return cls(stage_sizes=cfg["stage_sizes"], num_filters=cfg["num_filters"],
               num_classes=cfg["num_classes"], dtype=DTYPES[cfg["dtype"]],
               mesh=mesh)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN's convolutions and for matmuls, restored after:
    PyTorch lets cuDNN run float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which a float32 comparison
    must not."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def numpy_tree(tree: dict) -> dict:
    return tree_map(lambda t: t.detach().float().cpu().numpy().copy(), tree)


def rows_of(mesh, batch: int):
    """This rank's rows of a global batch of ``batch``."""
    if mesh is None:
        return slice(0, batch)
    n, r = mesh.axis_size("data"), mesh.coord("data")
    return slice(r * batch // n, (r + 1) * batch // n)


def train(mesh, cfg: dict, params: dict, stats: dict, images: np.ndarray,
          labels: np.ndarray, optimizer: str = "sgd",
          opt_state: dict = None, device: str = "cpu") -> dict:
    """``len(images)`` steps of the ResNet of ``cfg`` from the whole trees
    ``params``, ``stats`` and, if given, ``opt_state`` (optax's layout,
    Adam's ``count`` included), step i on this rank's rows of
    ``images[i]`` (NHWC f32) and ``labels[i]``; ``device`` where ``mesh``
    is None.  TF32 is off throughout (:func:`exact_float32`)."""
    with exact_float32():
        return _train(mesh, cfg, params, stats, images, labels, optimizer,
                      opt_state, device)


def _train(mesh, cfg, params, stats, images, labels, optimizer, opt_state,
           device) -> dict:
    dev = torch.device(device if mesh is None else mesh.device)
    state = place_resnet(make_model(cfg, mesh),
                         params_from_numpy(params, dev),
                         params_from_numpy(stats, dev),
                         opt_state=(None if opt_state is None else {
                             k: params_from_numpy(v, dev)
                             if isinstance(v, dict) else v
                             for k, v in opt_state.items()}),
                         optimizer=sgd() if optimizer == "sgd" else adam(),
                         mesh=mesh)
    mine = rows_of(mesh, images.shape[1])
    losses, grads, stats1 = [], None, None
    for im, lb in zip(images, labels):
        loss = resnet_grads(state,
                            torch.from_numpy(np.ascontiguousarray(
                                im[mine])).to(dev),
                            torch.from_numpy(lb[mine]).to(dev))
        if grads is None:
            grads = numpy_tree(grad_tree(state))
            stats1 = numpy_tree(state.batch_stats)
        state.opt.step()
        state.step += 1
        losses.append(loss.item())
    return dict(losses=losses, grads=grads, stats1=stats1,
                params=numpy_tree(state.params),
                stats=numpy_tree(state.batch_stats),
                opt_state={k: numpy_tree(v) if isinstance(v, dict)
                           else int(v)
                           for k, v in opt_state_tree(state).items()})


def timed_steps(mesh, cfg: dict, rows: int, steps: int, size: int,
                seed: int = 0, device: str = "cuda") -> dict:
    """``steps`` steps of the ResNet of ``cfg`` from fresh weights drawn
    from ``seed`` on this rank's device, on ``rows`` rows a rank of the
    global batches of ``synthetic_image_batches(rows x n, size)``, each
    step's parts timed apart after a synchronize: the loss's forward and
    backward, :func:`sync_grads` (the gradient mean over ``"data"``), the
    optimizer.  Returns the losses, those seconds a step, and the bytes
    each rank's gradient mean reduced."""
    dev = torch.device(device if mesh is None else mesh.device)
    model = make_model(cfg, mesh)
    params, stats = init_resnet_params(
        model, torch.Generator(device=dev).manual_seed(seed), dev)
    state = create_train_state(model, params, batch_stats=stats)
    n = 1 if mesh is None else mesh.axis_size("data")
    mine = rows_of(mesh, rows * n)
    source = synthetic_image_batches(rows * n, size=size,
                                     num_classes=cfg["num_classes"])
    out = dict(losses=[], step_s=[], grad_s=[], mean_s=[], opt_s=[])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(steps):
        images, labels = next(source)
        im = torch.from_numpy(np.ascontiguousarray(images[mine])).to(dev)
        lb = torch.from_numpy(labels[mine]).to(dev)
        sync()
        t0 = time.perf_counter()
        state.opt.zero_grad(set_to_none=True)
        loss, _ = resnet_loss(state, im, lb)
        loss.backward()
        sync()
        t1 = time.perf_counter()
        sync_grads(state)
        sync()
        t2 = time.perf_counter()
        state.opt.step()
        state.step += 1
        sync()
        t3 = time.perf_counter()
        out["losses"].append(loss.item())
        out["step_s"].append(t3 - t0)
        out["grad_s"].append(t1 - t0)
        out["mean_s"].append(t2 - t1)
        out["opt_s"].append(t3 - t2)
    out["mean_bytes"] = sum(p.numel() * p.element_size()
                            for p in model.parameters())
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    # the card's memory back for the next call in a shared gang
    del state, model, params, stats, im, lb, loss
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
