"""Start the ranks of a mesh as processes.

- :class:`Gang` keeps a mesh's ranks alive in child processes and runs a
  function on all of them at once, returning rank 0's result: the CPU
  tests and the card smoke start one gang and run their cases in it.
- :func:`start_ranks` starts chosen ranks of a mesh whose other ranks
  live elsewhere: the worker is rank 0 itself and starts the rest.

Ranks meet through a ``FileStore`` in a directory the caller gives (a
test's temporary directory), never a fixed TCP port.  Children are
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
from typing import Callable, List, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.parallel.mesh import close_mesh, device_mesh


def open_store(path: str, size: int):
    """The rendezvous store of a ``size``-rank mesh at ``path``."""
    return dist.FileStore(path, size)


def _rank_main(rank: int, axes, backend: str, devices: Sequence[str],
               store_path: str, timeout_s: float, inbox, results) -> None:
    torch.set_num_threads(1)
    mesh = device_mesh(axes, rank, backend=backend, device=devices[rank],
                       store=open_store(store_path, len(devices)),
                       timeout_s=timeout_s, devices=tuple(devices))
    try:
        while True:
            job = inbox.get()
            if job is None:
                return
            fn, args = job
            try:
                value = fn(mesh, *args)
            except Exception:   # noqa: BLE001 - reported to the parent
                results.put((rank, False, traceback.format_exc()))
                return
            results.put((rank, True, value if rank == 0 else None))
    finally:
        close_mesh(mesh)


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

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None):
        if not self._procs:
            self._start()
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
