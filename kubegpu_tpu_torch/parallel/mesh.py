"""The process mesh: the port of ``distributed_init_from_env`` and
``device_mesh`` (``kubegpu_tpu/parallel/mesh.py``) for the ``"model"`` mesh of
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
which sets each rank's device from its local rank.

A pod that the CRI shim makes one of a gang of pods reads its place in
the gang from the injected ``JAX_*`` env (:func:`distributed_init_from_env`,
a :class:`GangTable`); its ranks then join the other pods' in one
world through the coordinator's store (``parallel/launch.py``), global
rank ``process_id x L + i`` for its local rank i of L, the process-major
device order of JAX's gang.  ``Mesh.local_size`` records L.

A mesh with both ``"model"`` and ``"seq"`` (data x tensor x context
parallelism) also has a group for each ``"model"`` coordinate: the
ranks that differ from this one only along ``"data"`` and ``"seq"``
(:data:`DATA_SEQ`), over which the loss and the gradients are averaged.
:func:`remesh` lays the same world out as a mesh of another shape (new
groups over the same ranks), so one gang of processes can run several
meshes of its size in turn."""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Mapping, Optional, Tuple, Union

import os

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch.models.params import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
# the plane a 3-D mesh averages over: every rank of one "model" coordinate
DATA_SEQ = (DATA_AXIS, SEQ_AXIS)
BACKENDS = ("nccl", "gloo")
# the longest any wait of a gang's rendezvous lasts by default: a pod
# that never arrives makes the others fail after it
RENDEZVOUS_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class GangTable:
    """One pod's place in a gang of pods, from the shim's env: the
    coordinator's ``host`` and ``port`` (where process 0 serves the
    gang's store), the number of processes (pods) and this one's id;
    ``timeout_s`` bounds every wait of the rendezvous."""

    host: str
    port: int
    num_processes: int
    process_id: int
    timeout_s: float = RENDEZVOUS_TIMEOUT_S


def distributed_init_from_env(env: Optional[Mapping[str, str]] = None, *,
                              timeout_s: float = RENDEZVOUS_TIMEOUT_S
                              ) -> Optional[GangTable]:
    """The gang this process is one of, read from the injected rendezvous
    env (``kubegpu_tpu/crishim/inject.py::worker_env``), as the JAX
    function reads it: None when the job runs alone (no
    ``JAX_COORDINATOR_ADDRESS``, or ``JAX_NUM_PROCESSES`` <= 1, or a
    mangled process table without a coordinator), a :class:`GangTable`
    otherwise.  The process id is ``JAX_PROCESS_ID``, else
    ``TPU_WORKER_ID``, as the JAX worker reads it.  With a coordinator
    set, a mangled ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` raises
    ValueError: running alone would leave the other pods waiting at the
    rendezvous.  Joining the gang is ``parallel/launch.py``'s."""
    env = dict(os.environ if env is None else env)
    coord = env.get("JAX_COORDINATOR_ADDRESS")
    try:
        n = int(env.get("JAX_NUM_PROCESSES", "1"))
        pid = int(env.get("JAX_PROCESS_ID", env.get("TPU_WORKER_ID", "0")))
    except ValueError as e:
        if coord:
            raise ValueError(
                f"malformed JAX_NUM_PROCESSES/JAX_PROCESS_ID with "
                f"JAX_COORDINATOR_ADDRESS={coord!r} set") from e
        return None
    if not coord or n <= 1:
        return None
    host, sep, port = coord.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"JAX_COORDINATOR_ADDRESS={coord!r}: host:port")
    if not 0 <= pid < n:
        raise ValueError(f"JAX_PROCESS_ID={pid} outside a gang of {n}")
    return GangTable(host=host, port=int(port), num_processes=n,
                     process_id=pid, timeout_s=float(timeout_s))


@dataclass
class Mesh:
    """One rank's view of the mesh: ``size`` ranks in all, this process
    being ``rank``, along ``axis_names`` of ``axis_sizes`` (empty: one
    axis of ``size``).  ``group`` carries the ``"model"`` axis's tensor
    collectives (its backend is ``backend``), ``axis_groups`` every
    axis's group of this rank, ``control`` the host objects (always
    gloo), ``device`` is where this rank's tensors live.  ``local_size``
    is the number of ranks in this rank's pod (default ``size``: one
    host holds them all).  On a mesh with ``"model"`` and ``"seq"``,
    ``axis_groups[DATA_SEQ]`` is this rank's ``"data"`` x ``"seq"``
    plane."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    control: object = None
    axis_names: Tuple[str, ...] = (MODEL_AXIS,)
    devices: Tuple[str, ...] = field(default_factory=tuple)
    axis_sizes: Tuple[int, ...] = ()
    axis_groups: Dict[Union[str, Tuple[str, ...]], object] = field(
        default_factory=dict)
    local_size: Optional[int] = None
    timeout_s: float = 300.0

    def __post_init__(self) -> None:
        if self.local_size is None:
            self.local_size = self.size

    @property
    def local_rank(self) -> int:
        """This rank's index among its pod's ranks."""
        return self.rank % self.local_size

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

    def axis_group(self, axis: Union[str, Tuple[str, ...]]):
        """The process group of this rank's line along ``axis`` (or of
        its plane along a tuple of axes, :data:`DATA_SEQ`)."""
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


def _axis_lines(axes: Mapping[str, int], *along: str):
    """The ranks of every line of the mesh along ``along`` (one axis, or
    the plane of several, those the mesh lacks left out), each in
    coordinate order (row-major over ``along``), the lines in the order
    of the other coordinates: the groups every rank creates, in the same
    order."""
    along = [a for a in along if a in axes]
    sizes = tuple(axes.values())
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    names = list(axes)
    grid = np.moveaxis(grid, [names.index(a) for a in along],
                       range(-len(along), 0))
    width = int(np.prod([axes[a] for a in along]))
    return [list(map(int, line)) for line in grid.reshape(-1, width)]


def _mesh_groups(axes: Mapping[str, int], rank: int, timeout: timedelta
                 ) -> Dict[Union[str, Tuple[str, ...]], object]:
    """Create every group of a mesh of ``axes`` (every rank calls it, in
    one order: ``new_group`` is collective over the world) and return
    this rank's: one a line along each axis of a mesh of more than one,
    and on a mesh with ``"model"`` and ``"seq"`` the ``"data"`` x
    ``"seq"`` planes (:data:`DATA_SEQ`)."""
    groups: Dict[Union[str, Tuple[str, ...]], object] = {}
    along = [(axis,) for axis in axes] if len(axes) > 1 else []
    if MODEL_AXIS in axes and SEQ_AXIS in axes:
        along.append(DATA_SEQ)
    for names in along:
        for line in _axis_lines(axes, *names):
            g = dist.new_group(ranks=line, timeout=timeout)
            if rank in line:
                groups[names[0] if len(names) == 1 else names] = g
    return groups


def _axes(axes: Union[int, Mapping[str, int]]) -> Dict[str, int]:
    if isinstance(axes, int):
        axes = {MODEL_AXIS: axes}
    axes = {str(k): int(v) for k, v in axes.items()}
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes {axes}: every width must be >= 1")
    return axes


def device_mesh(axes: Union[int, Mapping[str, int]], rank: int, *,
                backend: str, device, store, timeout_s: float = 300.0,
                idle_timeout_s: Optional[float] = None,
                devices: Tuple[str, ...] = (),
                local_size: Optional[int] = None) -> Mesh:
    """Join the process group of ``axes`` (a mapping of axis name to
    width, e.g. ``{"data": 2, "model": 2}``, or an int: a one-axis
    ``"model"`` mesh of that many ranks) as ``rank`` through ``store``
    (a ``torch.distributed`` store every rank opens, e.g. a
    ``FileStore``) and return this rank's :class:`Mesh`.  ``timeout_s``
    bounds every collective of the tensors; ``idle_timeout_s`` (default
    the same) bounds the wait of a rank that replays rank 0's calls, so a
    server that idles longer needs a longer one.  ``devices`` names every
    rank's device, for the record; ``local_size`` is the ranks a pod of a
    gang holds (default: all of them, on one host).

    On a mesh of more than one axis every rank creates every axis's
    groups, its own and the others', in one order
    (:func:`_mesh_groups`): ``new_group`` is collective over the world."""
    axes = _axes(axes)
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
    groups = _mesh_groups(axes, rank, timeout)
    return Mesh(size=size, rank=rank, device=dev, backend=backend,
                group=groups.get(MODEL_AXIS, dist.group.WORLD),
                control=control, axis_names=tuple(axes),
                devices=tuple(devices),
                axis_sizes=tuple(axes.values()) if len(axes) > 1 else (),
                axis_groups=groups, local_size=local_size,
                timeout_s=timeout_s)


def remesh(mesh: Mesh, axes: Union[int, Mapping[str, int]]) -> Mesh:
    """The world of ``mesh`` laid out as a mesh of ``axes`` (as many
    ranks): the same rank, device, backend and control group, new
    groups for the new axes (every rank calls it, in one order).  One
    gang of processes then runs a mesh of another shape without
    starting again."""
    axes = _axes(axes)
    size = int(np.prod(list(axes.values())))
    if size != mesh.size:
        raise ValueError(f"mesh axes {axes} hold {size} ranks; the world "
                         f"holds {mesh.size}")
    groups = _mesh_groups(axes, mesh.rank, timedelta(seconds=mesh.timeout_s))
    return Mesh(size=size, rank=mesh.rank, device=mesh.device,
                backend=mesh.backend,
                group=groups.get(MODEL_AXIS, dist.group.WORLD),
                control=mesh.control, axis_names=tuple(axes),
                devices=mesh.devices,
                axis_sizes=tuple(axes.values()) if len(axes) > 1 else (),
                axis_groups=groups, local_size=mesh.local_size,
                timeout_s=mesh.timeout_s)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
