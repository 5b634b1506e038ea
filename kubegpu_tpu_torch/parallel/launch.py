"""Start the ranks of a mesh as processes.

- :class:`Gang` keeps a mesh's ranks alive in child processes and runs a
  function on all of them at once, returning rank 0's result: the CPU
  tests and the card smoke start one gang and run their cases in it.
- :func:`start_ranks` starts chosen ranks of a mesh whose other ranks
  live elsewhere: the worker is rank 0 itself and starts the rest.
- :func:`open_gang_store`, :func:`check_local_counts` and
  :func:`gang_backend` join the ranks of a gang of pods (and
  :func:`gang_slice_ids` reads a multislice gang's slices): every pod
  starts its own ranks, and all of them meet at the coordinator the
  shim's env names (``mesh.distributed_init_from_env``), or, for a pod
  that trains alone, at :func:`open_host_gang`'s store.

A :class:`Gang` meets through a ``FileStore`` in a directory the caller
gives (a test's temporary directory), never a fixed TCP port.  A gang
of pods meets through a ``TCPStore`` at the coordinator's address,
served by process 0's first rank, and a pod alone through one on a
loopback port the system picks; every wait there is bounded by the
gang table's ``timeout_s``.  Children are
started with ``spawn``, set one CPU thread each and run functions that
their modules must import without JAX.  Nothing waits without end: a
gang's call fails when a rank raises, dies or does not answer within
its timeout, and the gang's processes are then killed; every collective
has the process group's timeout as well."""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.parallel.mesh import (
    RENDEZVOUS_TIMEOUT_S,
    GangTable,
    close_mesh,
    device_mesh,
)

GANG_PREFIX = "kubegpu/gang/"


def open_store(path: str, size: int):
    """The rendezvous store of a ``size``-rank mesh at ``path``."""
    return dist.FileStore(path, size)


def open_gang_store(table: GangTable, *, is_master: bool):
    """The store of a gang of pods at the coordinator's address: served
    (``is_master``) by process 0's first rank, joined as a client by
    every other rank of every pod, a client retrying its connection for
    up to ``table.timeout_s``."""
    return dist.TCPStore(table.host, table.port, is_master=is_master,
                         timeout=timedelta(seconds=table.timeout_s),
                         wait_for_workers=False)


def open_host_gang(timeout_s: float = RENDEZVOUS_TIMEOUT_S):
    """A pod that trains alone as a gang of one: a ``TCPStore`` served on
    a loopback port the system picks (none is fixed), and its table.
    Returns ``(store, table)``."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          timeout=timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    return store, GangTable(host="127.0.0.1", port=store.port,
                            num_processes=1, process_id=0,
                            timeout_s=float(timeout_s))


def _wait(store, keys: List[str], table: GangTable, what: str) -> None:
    try:
        store.wait(keys, timedelta(seconds=table.timeout_s))
    except Exception as e:  # noqa: BLE001 - the store's timeout error
        missing = [k for k in keys if not store.check([k])]
        raise RuntimeError(
            f"gang rendezvous at {table.host}:{table.port}: {what} did not "
            f"arrive within {table.timeout_s} s (missing {missing})") from e


def check_local_counts(store, table: GangTable, local: int) -> None:
    """Publish this pod's rank count ``local`` and wait for every pod's:
    the world is ``num_processes x local`` only if every pod holds as
    many ranks, so a pod that differs makes every pod raise, naming both
    counts.  Each pod's first rank calls it before starting its other
    ranks."""
    store.set(f"{GANG_PREFIX}local/{table.process_id}", str(int(local)))
    keys = [f"{GANG_PREFIX}local/{p}" for p in range(table.num_processes)]
    _wait(store, keys, table, "every pod's rank count")
    counts = [int(store.get(k)) for k in keys]
    for p, n in enumerate(counts):
        if n != local:
            raise RuntimeError(
                f"gang of {table.num_processes} pods: process "
                f"{table.process_id} holds {local} rank(s) and process {p} "
                f"holds {n}; every pod must hold as many ({counts})")


def gang_slice_ids(store, table: GangTable, local: int,
                   env: Optional[Mapping[str, str]] = None) -> List[int]:
    """Every global rank's slice (``mesh.hybrid_device_mesh``'s
    ``slice_ids``): each pod publishes its ``MEGASCALE_SLICE_ID`` (0 for
    a gang on one slice) and reads every pod's; rank ``p x local + i``
    is on process p's slice."""
    env = os.environ if env is None else env
    mine = int(env.get("MEGASCALE_SLICE_ID", "0"))
    store.set(f"{GANG_PREFIX}slice/{table.process_id}", str(mine))
    keys = [f"{GANG_PREFIX}slice/{p}" for p in range(table.num_processes)]
    _wait(store, keys, table, "every pod's slice id")
    return [int(store.get(k)) for k in keys for _ in range(local)]


def device_identity(device: torch.device) -> str:
    """What a rank publishes of its device: the card's UUID, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return "cuda:" + str(torch.cuda.get_device_properties(device).uuid)


def gang_backend(store, table: GangTable, rank: int, size: int,
                 device: torch.device) -> str:
    """The backend of a gang's world, the same on every rank because it
    comes from what every rank publishes: its device's identity
    (:func:`device_identity`).  NCCL when every rank has a card of its
    own, gloo when any rank is on the CPU or two share a card (NCCL
    refuses two ranks on one GPU).  Nothing is tried and fallen back
    from."""
    store.set(f"{GANG_PREFIX}device/{rank}", device_identity(device))
    keys = [f"{GANG_PREFIX}device/{r}" for r in range(size)]
    _wait(store, keys, table, "every rank's device")
    ids = [store.get(k).decode() for k in keys]
    cards = [i for i in ids if i.startswith("cuda:")]
    return ("nccl" if len(cards) == size and len(set(cards)) == size
            else "gloo")


def _rank_main(rank: int, axes, backend: str, devices: Sequence[str],
               store_path: str, timeout_s: float, inbox, results) -> None:
    torch.set_num_threads(1)
    mesh = device_mesh(axes, rank, backend=backend, device=devices[rank],
                       store=open_store(store_path, len(devices)),
                       timeout_s=timeout_s, devices=tuple(devices))
    # the ranks leave together when the parent closes the gang; a rank
    # whose call failed leaves at once (its peers may wait for it in a
    # collective of that call)
    orderly = False
    try:
        while True:
            job = inbox.get()
            if job is None:
                orderly = True
                return
            fn, args = job
            try:
                value = fn(mesh, *args)
            except Exception:   # noqa: BLE001 - reported to the parent
                results.put((rank, False, traceback.format_exc()))
                return
            results.put((rank, True, value if rank == 0 else None))
    finally:
        close_mesh(mesh, orderly)


class Gang:
    """The ranks of one mesh in child processes: ``axes`` is the mesh's
    shape (``{"data": 2, "model": 2}``, or an int: that many ranks on one
    ``"model"`` axis, as :func:`device_mesh` takes it), on ``devices``
    (one per rank, e.g. ``cuda:0..n-1`` over ``"nccl"``, or ``"cpu"``
    for each over ``"gloo"``) over ``backend``: the caller names both,
    as :func:`device_mesh` needs them.  :meth:`run` calls
    ``fn(mesh, *args)`` on every rank and returns rank 0's value.  A call
    that fails (a rank raised, died or passed ``timeout_s``) kills the
    gang and raises; the next call starts a fresh one."""

    def __init__(self, axes: Union[int, Mapping[str, int]], store_dir: str,
                 *, backend: str, devices: Sequence[str],
                 timeout_s: float = 120.0) -> None:
        self.axes = axes if isinstance(axes, int) else dict(axes)
        self.size = (axes if isinstance(axes, int)
                     else math.prod(self.axes.values()))
        self.backend = backend
        self.devices = tuple(devices)
        if len(self.devices) != self.size:
            raise ValueError(f"{self.size} ranks need {self.size} devices, "
                             f"got {self.devices}")
        self.store_dir = store_dir
        self.timeout_s = timeout_s
        self._ctx = mp.get_context("spawn")
        self._procs: List = []
        self._generation = 0

    def _start(self) -> None:
        self._generation += 1
        store = os.path.join(self.store_dir, f"gang-{self._generation}")
        self._inboxes = [self._ctx.Queue() for _ in range(self.size)]
        self._results = self._ctx.Queue()
        procs = [
            self._ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, self.axes, self.backend, self.devices, store,
                      self.timeout_s, self._inboxes[r], self._results))
            for r in range(self.size)
        ]
        for p in procs:
            p.start()
            self._procs.append(p)

    def start(self) -> "Gang":
        """Start the ranks now, if they are not running (:meth:`run`
        starts them otherwise), so that several gangs start together."""
        if not self._procs:
            self._start()
        return self

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None):
        self.start()
        for q in self._inboxes:
            q.put((fn, args))
        deadline = time.monotonic() + (timeout_s or self.timeout_s)
        got, failures = {}, []
        while len(got) + len(failures) < self.size:
            try:
                rank, ok, value = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()
                        and r not in got and r not in dict(failures)]
                if dead or time.monotonic() > deadline:
                    self.kill()
                    why = (f"rank(s) {dead} died" if dead else
                           f"no answer within {timeout_s or self.timeout_s}"
                           " s")
                    raise RuntimeError(
                        f"{getattr(fn, '__name__', fn)}: {why}"
                        + "".join(f"\nrank {r}:\n{tb}" for r, tb in failures))
                continue
            if ok:
                got[rank] = value
            else:
                failures.append((rank, value))
                # the other ranks may wait in a collective for this one:
                # give them a moment to report, then stop them
                deadline = min(deadline, time.monotonic() + 5.0)
        if failures:
            self.kill()
            raise RuntimeError(
                f"{getattr(fn, '__name__', fn)} failed on "
                f"{len(failures)} rank(s):"
                + "".join(f"\nrank {r}:\n{tb}" for r, tb in failures))
        return got[0]

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop every rank (killing any that does not leave in time)."""
        if not self._procs:
            return
        for q in self._inboxes:
            q.put(None)
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()

    def __enter__(self) -> "Gang":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_ranks(target: Callable, ranks: Sequence[int], *args) -> List:
    """Start ``target(rank, *args)`` for each of ``ranks`` in a spawned
    daemon process (the caller, typically rank 0, joins the same mesh
    itself).  Returns the processes; :func:`join_ranks` ends them."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args), daemon=True)
             for r in ranks]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs: Sequence, timeout_s: float = 60.0) -> List[int]:
    """Wait for processes from :func:`start_ranks`, killing any still
    running after ``timeout_s``; returns their exit codes."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    return [p.exitcode for p in procs]
