"""The tensor-parallel mesh: the port of ``device_mesh``
(``kubegpu_tpu/parallel/mesh.py``) for a one-axis ``"model"`` mesh, and
of ``tp_size`` (``kubegpu_tpu/parallel/sharding.py``).

The JAX package runs one controller over every device; the port runs one
process per rank.  A :class:`Mesh` is what one rank knows of the mesh:
its rank and the width, the process group its tensors' collectives run
over, a gloo group for host objects (the replay of a batcher's calls),
this rank's device and the backend.  The caller chooses the backend:
NCCL for ranks on distinct cards, gloo on the CPU, and gloo for ranks
that share one card (NCCL refuses two ranks on one GPU).  Nothing is
chosen by probing.  The mesh is built from an explicit group and device,
not through ``init_device_mesh``, which sets each rank's device from its
local rank."""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.models.params import resolve_device

MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    """One rank's view of a one-axis mesh: ``size`` ranks along
    ``axis_names[0]``, this process being ``rank``.  ``group`` carries
    the tensor collectives (its backend is ``backend``), ``control`` the
    host objects (always gloo), ``device`` is where this rank's tensors
    live."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    control: object = None
    axis_names: Tuple[str, ...] = (MODEL_AXIS,)
    devices: Tuple[str, ...] = field(default_factory=tuple)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}


def tp_size(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel width a mesh carries (1 without a mesh or a
    ``"model"`` axis)."""
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[MODEL_AXIS])


def device_mesh(size: int, rank: int, *, backend: str, device, store,
                timeout_s: float = 300.0,
                idle_timeout_s: Optional[float] = None,
                devices: Tuple[str, ...] = ()) -> Mesh:
    """Join a ``size``-rank process group as ``rank`` through ``store``
    (a ``torch.distributed`` store every rank opens, e.g. a
    ``FileStore``) and return this rank's :class:`Mesh`.  ``timeout_s``
    bounds every collective of the tensors; ``idle_timeout_s`` (default
    the same) bounds the wait of a rank that replays rank 0's calls, so a
    server that idles longer needs a longer one.  ``devices`` names every
    rank's device, for the record."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs every rank on a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    control = dist.new_group(
        backend="gloo",
        timeout=timedelta(seconds=idle_timeout_s or timeout_s))
    return Mesh(size=size, rank=rank, device=dev, backend=backend,
                group=dist.group.WORLD, control=control,
                devices=tuple(devices))


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
