"""The process mesh: the port of ``device_mesh``
(``kubegpu_tpu/parallel/mesh.py``) for the ``"model"`` mesh of
tensor-parallel serving, the ``("data", "model")`` mesh of data x
tensor-parallel training, the ``("data", "seq")`` mesh of
context-parallel training, the ``("data", "expert"[, "model"])`` mesh
of expert-parallel MoE training and the ``("pipe"[, "model"])`` mesh of
pipeline-parallel training, and of ``tp_size``
(``kubegpu_tpu/parallel/sharding.py``) and its ``"seq"``, ``"expert"``
and ``"pipe"`` counterparts ``cp_size``, ``ep_size`` and ``pp_size``.

The JAX package runs one controller over every device; the port runs one
process per rank.  A :class:`Mesh` is what one rank knows of the mesh:
its rank in the world and the world's size, the axes and this rank's
coordinate on each (row-major, the trailing axis fastest, as JAX lays
devices out: on ``{"data": dp, "model": tp}`` rank r sits at data
``r // tp``, model ``r % tp``; on ``{"pipe": pp, "model": tp}`` at pipe
``r // tp``, model ``r % tp``), one process group per axis (the ranks
that differ from this one only along that axis), a gloo group for host
objects (the replay of a batcher's calls), this rank's device and the
backend.  ``group`` is the ``"model"`` axis's group, the one the
tensor-parallel collectives run over (the world on a one-axis mesh).

The caller chooses the backend: NCCL for ranks on distinct cards, gloo
on the CPU, and gloo for ranks that share one card (NCCL refuses two
ranks on one GPU).  Nothing is chosen by probing.  The mesh is built
from an explicit group and device, not through ``init_device_mesh``,
which sets each rank's device from its local rank."""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch.models.params import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    """One rank's view of the mesh: ``size`` ranks in all, this process
    being ``rank``, along ``axis_names`` of ``axis_sizes`` (empty: one
    axis of ``size``).  ``group`` carries the ``"model"`` axis's tensor
    collectives (its backend is ``backend``), ``axis_groups`` every
    axis's group of this rank, ``control`` the host objects (always
    gloo), ``device`` is where this rank's tensors live."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    control: object = None
    axis_names: Tuple[str, ...] = (MODEL_AXIS,)
    devices: Tuple[str, ...] = field(default_factory=tuple)
    axis_sizes: Tuple[int, ...] = ()
    axis_groups: Dict[str, object] = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes or (self.size,)))

    def axis_size(self, axis: str) -> int:
        """The width of ``axis`` (1 where the mesh lacks it)."""
        return int(self.shape.get(axis, 1))

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 where the mesh lacks
        it)."""
        if axis not in self.axis_names:
            return 0
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[self.axis_names.index(axis)])

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis in self.axis_groups:
            return self.axis_groups[axis]
        if self.axis_names == (axis,):
            return self.group
        raise ValueError(f"the mesh {self.shape} has no group for {axis!r}")


def tp_size(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel width a mesh carries (1 without a mesh or a
    ``"model"`` axis)."""
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[MODEL_AXIS])


def cp_size(mesh: Optional[Mesh]) -> int:
    """The context-parallel width a mesh carries (1 without a mesh or a
    ``"seq"`` axis)."""
    if mesh is None or SEQ_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[SEQ_AXIS])


def ep_size(mesh: Optional[Mesh]) -> int:
    """The expert-parallel width a mesh carries (1 without a mesh or an
    ``"expert"`` axis)."""
    if mesh is None or EXPERT_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[EXPERT_AXIS])


def pp_size(mesh: Optional[Mesh]) -> int:
    """The pipeline's stage count a mesh carries (1 without a mesh or a
    ``"pipe"`` axis)."""
    if mesh is None or PIPE_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[PIPE_AXIS])


def _axis_lines(axes: Mapping[str, int], axis: str):
    """The ranks of every line of the mesh along ``axis``, each line in
    coordinate order, the lines in the order of the other coordinates:
    the groups every rank creates, in the same order."""
    sizes = tuple(axes.values())
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    grid = np.moveaxis(grid, list(axes).index(axis), -1)
    return [list(map(int, line)) for line in grid.reshape(-1, axes[axis])]


def device_mesh(axes: Union[int, Mapping[str, int]], rank: int, *,
                backend: str, device, store, timeout_s: float = 300.0,
                idle_timeout_s: Optional[float] = None,
                devices: Tuple[str, ...] = ()) -> Mesh:
    """Join the process group of ``axes`` (a mapping of axis name to
    width, e.g. ``{"data": 2, "model": 2}``, or an int: a one-axis
    ``"model"`` mesh of that many ranks) as ``rank`` through ``store``
    (a ``torch.distributed`` store every rank opens, e.g. a
    ``FileStore``) and return this rank's :class:`Mesh`.  ``timeout_s``
    bounds every collective of the tensors; ``idle_timeout_s`` (default
    the same) bounds the wait of a rank that replays rank 0's calls, so a
    server that idles longer needs a longer one.  ``devices`` names every
    rank's device, for the record.

    On a mesh of more than one axis every rank creates every axis's
    groups, its own and the others', in one order
    (:func:`_axis_lines`): ``new_group`` is collective over the world."""
    if isinstance(axes, int):
        axes = {MODEL_AXIS: axes}
    axes = {str(k): int(v) for k, v in axes.items()}
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes {axes}: every width must be >= 1")
    size = int(np.prod(list(axes.values())))
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs every rank on a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size, timeout=timeout)
    control = dist.new_group(
        backend="gloo",
        timeout=timedelta(seconds=idle_timeout_s or timeout_s))
    groups: Dict[str, object] = {}
    if len(axes) > 1:
        for axis in axes:
            for line in _axis_lines(axes, axis):
                g = dist.new_group(ranks=line, timeout=timeout)
                if rank in line:
                    groups[axis] = g
    group = groups.get(MODEL_AXIS, dist.group.WORLD)
    return Mesh(size=size, rank=rank, device=dev, backend=backend,
                group=group, control=control, axis_names=tuple(axes),
                devices=tuple(devices),
                axis_sizes=tuple(axes.values()) if len(axes) > 1 else (),
                axis_groups=groups)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
