"""Checkpoint and resume of a training state: the port of
``kubegpu_tpu/models/checkpoint.py`` (``make_manager``,
``save_checkpoint``, ``latest_step``, ``restore_checkpoint``), in a
format of its own instead of Orbax's.

A pod that dies is rescheduled and its worker resumes from the last
checkpoint instead of step 0; a serving replica loads what training
wrote.  Each saved step is one directory ``<root>/<step>/`` holding:

- ``state.npz``: an uncompressed npz (a zip of ``.npy`` members), one
  member a leaf of the WHOLE training tree, named by its ``/``-joined
  path: ``params/...``, the optimizer state in optax's layout under
  ``opt_state/`` (``trace/...`` for SGD; ``mu/...``, ``nu/...`` and
  ``count`` for Adam; see ``train.Optimizer``), a ResNet's BatchNorm
  statistics under ``batch_stats/`` (``.../mean``, ``.../var``; the LM
  has none) and ``step``.  Parameters, moments and statistics are
  float32, as the reference's training state is;
- ``checkpoint.json``: the format's name and version, the step, the
  optimizer's name and hyperparameters, the model's dims (the LM's
  widths; a ResNet's ``family``, ``layout``, ``stage_sizes``,
  ``num_filters``, ``num_classes`` and ``image_size``; the MoE
  transformer's widths with ``family`` "moe", ``num_experts``,
  ``capacity_factor``, ``mlp_ratio``, ``router_type`` and
  ``dispatch_impl``) and the list of ``batch_stats`` leaves.

A save writes a temporary directory (a name that is not a number, so no
reader takes it for a step) and renames it into place: a half-written
step is never the latest.  The manager keeps the last ``max_to_keep``
steps.  Saving a step that exists replaces it.

Because the checkpoint holds the whole tree, it restores on any mesh (a
ZeRO-1 state's too: its optimizer slices are saved whole), as Orbax
restores into the template's shardings: every rank opens the file
and reads it one leaf at a time (a member is read, and its CRC checked,
when it is asked for), keeps its Megatron shard of the leaf on its own
device and drops the rest, so a rank's host memory peaks at one leaf
(the MoE transformer's expert leaves cut along ``"expert"`` and, under
EP x TP, ``"model"``, by the model's ``shard_rules``).  Saving gathers
one leaf at a time over the ranks of data shard 0 and global rank 0
writes; every rank then meets at a barrier.

A leaf whose shape or dtype differs from the model's raises and names
the leaf, as does a missing or an extra leaf.  A step directory that is
not in this format raises too; one written by Orbax (the JAX package's
worker) names the converter, ``tools/orbax_to_torch_checkpoint.py``.
Neither is ever taken for "no checkpoint".
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
import zipfile
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch.models.params import Tree, resolve_device
from kubegpu_tpu_torch.models.train import (
    Optimizer,
    TrainState,
    iter_whole_state,
    refresh_slices,
    set_param_opt_state,
)
from kubegpu_tpu_torch.parallel.mesh import DATA_AXIS
from kubegpu_tpu_torch.parallel.sharding import (
    mesh_place,
    place_slice,
    placed_dims,
    rules_of,
    whole_shape,
)

log = logging.getLogger(__name__)

FORMAT = "kubegpu_tpu_torch.checkpoint"
VERSION = 1
STATE_FILE = "state.npz"
META_FILE = "checkpoint.json"
CONVERTER = "tools/orbax_to_torch_checkpoint.py"
# what an Orbax step directory holds (CheckpointManager's metadata, the
# default item, a PyTree checkpoint's own metadata)
ORBAX_MARKS = ("_CHECKPOINT_METADATA", "default", "_METADATA",
               "manifest.ocdbt")


class StepReader:
    """One saved step, open for reading a leaf at a time (``leaf``).
    Use as a context manager: it holds the npz open.

    A leaf is read straight from its stored member's offset into the
    array's own buffer, and its CRC-32 checked against the zip's record:
    ``np.load``'s path through ``zipfile`` reads a member in small
    chunks at about a third of the rate of one read."""

    def __init__(self, path: str, meta: dict) -> None:
        self.path = path
        self.meta = meta
        self.step = int(meta["step"])
        self._file = open(os.path.join(path, STATE_FILE), "rb")
        with zipfile.ZipFile(self._file) as zf:
            self._members = {i.filename[:-len(".npy")]: i
                             for i in zf.infolist()
                             if i.filename.endswith(".npy")}
        self.keys = frozenset(self._members)

    def _read(self, key: str) -> np.ndarray:
        info, f = self._members[key], self._file
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"checkpoint {self.path} leaf {key!r} is "
                             "compressed; this format stores leaves")
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"checkpoint {self.path} leaf {key!r}: no zip "
                             "member at its offset")
        name_len = int.from_bytes(local[26:28], "little")
        extra_len = int.from_bytes(local[28:30], "little")
        f.seek(info.header_offset + 30 + name_len + extra_len)
        start = f.tell()
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        header_len = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(header_len))
        flat = np.empty(int(np.prod(shape)), dtype)
        view = memoryview(flat).cast("B")
        got = 0
        while got < len(view):
            n = f.readinto(view[got:])
            if not n:
                break
            got += n
        crc = zlib.crc32(view, crc)
        if (header_len + got != info.file_size
                or crc != info.CRC):
            raise ValueError(f"checkpoint {self.path} leaf {key!r} is "
                             "corrupt (size or CRC-32 differs from the "
                             "zip's record)")
        return (flat.reshape(shape[::-1]).T if fortran
                else flat.reshape(shape))

    def leaf(self, key: str, shape: Optional[Tuple[int, ...]] = None,
             dtype=None) -> np.ndarray:
        """The leaf ``key``, read now; raises naming the leaf when it is
        missing or its shape or dtype is not the one given."""
        if key not in self.keys:
            raise KeyError(f"checkpoint {self.path} has no leaf {key!r}")
        a = self._read(key)
        if shape is not None and tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"checkpoint {self.path} leaf {key!r}: shape "
                f"{tuple(a.shape)} does not match the model's {tuple(shape)}")
        if dtype is not None and a.dtype != np.dtype(dtype):
            raise ValueError(
                f"checkpoint {self.path} leaf {key!r}: dtype {a.dtype}, "
                f"the model needs {np.dtype(dtype)}")
        return a

    def check_keys(self, prefix: str, want: Iterable[str]) -> None:
        """Every leaf under ``prefix`` is one of ``want`` and every one
        of ``want`` is there; raises naming the first that is not."""
        want = set(want)
        have = {k for k in self.keys if k.startswith(prefix)}
        for key in sorted(have - want):
            raise ValueError(f"checkpoint {self.path} leaf {key!r} is not "
                             "in the model (another depth or layout)")
        for key in sorted(want - have):
            raise KeyError(f"checkpoint {self.path} has no leaf {key!r}")

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "StepReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CheckpointManager:
    """The steps saved under ``directory`` (created at the first save),
    keeping the last ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """Every step directory (a number), ascending; temporary
        directories of a save in progress or cut short are not steps."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> dict:
        """The step's ``checkpoint.json``; raises for a directory of
        another format (naming the converter for Orbax's)."""
        path = self.step_dir(step)
        try:
            with open(os.path.join(path, META_FILE)) as f:
                meta = json.load(f)
        except FileNotFoundError:
            names = set(os.listdir(path)) if os.path.isdir(path) else set()
            if names & set(ORBAX_MARKS):
                raise ValueError(
                    f"{path} is an Orbax checkpoint (the JAX package's "
                    f"format), not this port's: convert it with python "
                    f"{CONVERTER} --src <the JAX --ckpt-dir> --dst <a new "
                    "--ckpt-dir>") from None
            raise ValueError(f"{path} is not a checkpoint of this port (no "
                             f"{META_FILE})") from None
        if meta.get("format") != FORMAT or meta.get("version") != VERSION:
            raise ValueError(f"{path}: format {meta.get('format')!r} version "
                             f"{meta.get('version')!r}, this port reads "
                             f"{FORMAT!r} version {VERSION}")
        return meta

    def open(self, step: int) -> StepReader:
        return StepReader(self.step_dir(step), self.read_meta(step))

    def nbytes(self, step: int) -> int:
        """The bytes of a saved step's files."""
        path = self.step_dir(step)
        return sum(os.path.getsize(os.path.join(path, n))
                   for n in os.listdir(path))

    def write(self, step: int, leaves: Iterable[Tuple[str, np.ndarray]],
              meta: Mapping) -> str:
        """Write ``leaves`` (``(path, array)`` pairs, consumed one at a
        time) and ``meta`` as step ``step``: into a temporary directory,
        flushed to disk, then renamed into place; then drop the steps
        past ``max_to_keep``.  Returns the step's directory."""
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory,
                           f".tmp-{int(step)}-{uuid.uuid4().hex[:12]}")
        os.mkdir(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as raw:
                with zipfile.ZipFile(raw, "w", zipfile.ZIP_STORED,
                                     allowZip64=True) as zf:
                    for key, arr in leaves:
                        arr = np.asarray(arr, order="C")
                        with zf.open(key + ".npy", "w",
                                     force_zip64=True) as f:
                            # the npy header, then the leaf's bytes in
                            # one write (no chunked copy)
                            np.lib.format.write_array_header_1_0(
                                f, np.lib.format.header_data_from_array_1_0(
                                    arr))
                            f.write(memoryview(arr).cast("B"))
                raw.flush()
                os.fsync(raw.fileno())
            meta = dict(meta, format=FORMAT, version=VERSION,
                        step=int(step))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            final = self.step_dir(step)
            old = None
            if os.path.exists(final):
                old = f"{tmp}-replaced"
                os.rename(final, old)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(self.directory)
        self.prune()
        return final

    def prune(self) -> None:
        """Remove the oldest of this format's steps past
        ``max_to_keep``."""
        mine = [s for s in self.all_steps()
                if os.path.exists(os.path.join(self.step_dir(s), META_FILE))]
        for step in mine[:max(len(mine) - self.max_to_keep, 0)]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def make_manager(ckpt_dir: str, max_to_keep: int = 3) -> CheckpointManager:
    """A manager of the steps under ``ckpt_dir``, keeping the last
    ``max_to_keep``; the directory is created at the first save."""
    return CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)


def latest_step(mgr: CheckpointManager) -> Optional[int]:
    return mgr.latest_step()


def model_dims(model) -> Dict[str, object]:
    """The model's dims, as a checkpoint records them: a ResNet's or the
    MoE transformer's own (``dims()``), else the LM's widths."""
    if hasattr(model, "dims"):
        return model.dims()
    return {k: getattr(model, k, None)
            for k in ("vocab_size", "num_layers", "num_heads", "hidden",
                      "max_seq")}


def _stats_keys(model) -> List[str]:
    return [f"batch_stats/{_path(n)}" for n, _ in model.named_buffers()]


def save_checkpoint(mgr: CheckpointManager, state: TrainState) -> int:
    """Save the whole training tree at its current step; returns the
    step.  Over a mesh every rank calls it: the ``"model"`` ranks of data
    shard 0 (under ZeRO-1 every rank) gather each leaf in turn, global
    rank 0 writes, and every rank waits at a barrier until the step is
    in place."""
    step = int(state.step)
    mesh = state.mesh
    # ZeRO-1's optimizer slices are gathered over "data": every rank
    if mesh is None or mesh.coord(DATA_AXIS) == 0 or state.zero1:
        leaves = ((k, t.cpu().numpy()) for k, t in iter_whole_state(state))
        if mesh is None or mesh.rank == 0:
            mgr.write(step, _with_step(leaves, step), dict(
                optimizer=state.optimizer.config(),
                model=model_dims(state.model),
                batch_stats=_stats_keys(state.model)))
        else:
            for _ in leaves:   # this rank's part of each gather
                pass
    if mesh is not None:
        dist.barrier(group=mesh.control)
    return step


def _with_step(leaves, step: int):
    yield from leaves
    yield "step", np.asarray(step, np.int32)


def _check_optimizer(reader: StepReader, optimizer: Optimizer) -> None:
    """The saved state is the optimizer's kind (its hyperparameters are
    the run's to choose)."""
    saved = reader.meta.get("optimizer", {}).get("name")
    if saved != optimizer.name:
        raise ValueError(
            f"checkpoint {reader.path} holds {saved!r} optimizer state; "
            f"this run trains with {optimizer.name!r}")


def _path(name: str) -> str:
    return name.replace(".", "/")


def restore_checkpoint(mgr: CheckpointManager, template: TrainState,
                       step: Optional[int] = None) -> Optional[TrainState]:
    """Restore step ``step`` (default the latest) INTO ``template``, a
    state built as for a fresh run (model, placement, optimizer): its
    parameters and BatchNorm statistics are overwritten in place, its
    optimizer state and step set.  Over a mesh every rank calls it and
    keeps its shard of each leaf on its own device (a ResNet's every
    leaf whole, on any ``"data"`` size; the MoE transformer's on any
    ``("data", "expert"[, "model"])`` mesh; under ZeRO-1 each optimizer
    leaf's ``"data"`` slice).  Returns the template, or None when the
    directory holds no checkpoint."""
    step = mgr.latest_step() if step is None else step
    if step is None:
        return None
    place = mesh_place(template.mesh)
    rules = rules_of(template.model)
    optimizer = template.optimizer
    named = list(template.model.named_parameters())

    def mine(path: str, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            place_slice(a, placed_dims(path, a.ndim, place, rules), place))

    with mgr.open(step) as ckpt:
        _check_optimizer(ckpt, optimizer)
        ckpt.check_keys("params/", (f"params/{_path(n)}" for n, _ in named))
        ckpt.check_keys("batch_stats/", _stats_keys(template.model))
        for slot in optimizer.slots:
            ckpt.check_keys(f"opt_state/{slot}/",
                            (f"opt_state/{slot}/{_path(n)}" for n, _ in named))
        count = None
        if optimizer.name == "adam":
            count = int(ckpt.leaf("opt_state/count", (), np.int32))
        with torch.no_grad():
            for name, param in named:
                path = _path(name)
                shape = whole_shape(
                    param.shape, placed_dims(path, param.ndim, place, rules),
                    place)
                a = ckpt.leaf(f"params/{path}", shape, np.float32)
                param.copy_(mine(path, a))
                # each leaf was read fresh: it becomes the state uncopied
                set_param_opt_state(template, param, {
                    slot: mine(path, ckpt.leaf(f"opt_state/{slot}/{path}",
                                               shape, np.float32))
                    for slot in optimizer.slots}, count, copy=False)
            for name, buf in template.model.named_buffers():
                buf.copy_(torch.from_numpy(ckpt.leaf(
                    f"batch_stats/{_path(name)}", tuple(buf.shape),
                    np.float32)))
        refresh_slices(template)
        template.step = int(ckpt.leaf("step", ()))
    log.info("restored checkpoint step=%d", template.step)
    return template


def restore_params(mgr: CheckpointManager, cfg: Mapping, *, device="cuda",
                   dtype=torch.float32,
                   step: Optional[int] = None) -> Optional[Tuple[Tree, int]]:
    """The parameter leaves only of step ``step`` (default the latest),
    for serving: each leaf read, checked against the LM of ``cfg``
    (``vocab_size, num_layers, num_heads, hidden, max_seq``), copied onto
    ``device`` and cast to ``dtype`` there, one at a time; the optimizer
    state is never read.  Returns ``(params, step)``, or None when the
    directory holds no checkpoint."""
    from kubegpu_tpu_torch.models.transformer import TransformerLM

    step = mgr.latest_step() if step is None else step
    if step is None:
        return None
    dev = resolve_device(device)
    shapes = {f"params/{_path(n)}": tuple(p.shape) for n, p in
              TransformerLM(**cfg).named_parameters()}
    tree: Tree = {}
    with mgr.open(step) as ckpt:
        ckpt.check_keys("params/", shapes)
        for key, shape in shapes.items():
            a = ckpt.leaf(key, shape, np.float32)
            node = tree
            parts = key.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(a).to(dev).to(dtype)
        got = int(ckpt.leaf("step", ()))
    return tree, got
