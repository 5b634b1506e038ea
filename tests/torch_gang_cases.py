"""Pods of a gang as OS processes, shared by the CPU tests of the port's
gang rendezvous and the card smoke's gang phases: each pod runs the
worker (``-m kubegpu_tpu_torch.models.worker``) or a ``-c`` script that
calls one of its ``run_*`` functions and prints the full-precision
losses, with the rendezvous env the caller gives it (the CRI shim's
``worker_env``, the coordinator on loopback).  A JAX-free module: the
card machine has no JAX, and a pod's spawned ranks import it
(:func:`float32_training`).

Every pod is killed when any pod passes its time limit, so no caller
leaves a pod waiting at the rendezvous."""

from __future__ import annotations

import ast
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
RENDEZVOUS_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID", "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES")
# the line a pod script prints its losses on
LOSSES = "LOSSES "


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _float32_models() -> None:
    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.models.params import init_params, tree_map

    class Float32LM(worker.TransformerLM):
        def __init__(self, *args, **kwargs):
            kwargs["dtype"] = torch.float32
            super().__init__(*args, **kwargs)

    def init_on_cpu(cfg, generator, dtype, device):
        # a card's generator draws other numbers from the same seed
        gen = torch.Generator().manual_seed(worker.WEIGHT_SEED)
        return tree_map(lambda t: t.to(device),
                        init_params(cfg, gen, dtype, "cpu"))

    worker.RESNET_DTYPE = torch.float32
    worker.TransformerLM = Float32LM
    worker.init_params = init_on_cpu


def _rank_float32(*args) -> None:
    from kubegpu_tpu_torch.models import worker

    _float32_models()
    worker._train_rank(*args)


def float32_training() -> None:
    """Compute the worker's ResNets and its ``--model lm``/``lm-cp`` in
    float32 (bf16 in each fresh process), the LM from weights drawn on
    the CPU (so a card's run starts where the CPU's does), in this
    process and in the ranks it starts."""
    from kubegpu_tpu_torch.models import worker

    _float32_models()
    worker._train_rank = _rank_float32


def pod_script(run: str, argv: Sequence[str], *, fp32: bool = False,
               timeout_s: Optional[float] = None) -> List[str]:
    """A pod's interpreter arguments: ``worker.<run>`` on ``argv`` with
    one torch thread, then the worker's launch and peak lines and
    ``LOSSES <repr>``.  ``fp32`` trains in float32
    (:func:`float32_training`); ``timeout_s`` bounds the rendezvous's
    waits."""
    lines = ["import torch", "torch.set_num_threads(1)",
             "from kubegpu_tpu_torch.models import worker"]
    if fp32:
        lines += ["import torch_gang_cases",
                  "torch_gang_cases.float32_training()"]
    if timeout_s is not None:
        lines += ["import functools",
                  "from kubegpu_tpu_torch.parallel import mesh",
                  "worker.distributed_init_from_env = functools.partial("
                  f"mesh.distributed_init_from_env, timeout_s={timeout_s!r})"]
    report = "report_resnet" if run == "run_resnet" else "report_lm"
    lines += [f"r = worker.{run}(worker.build_parser().parse_args("
              f"{list(argv)!r}))",
              f"worker.{report}(r)",
              f"print({LOSSES!r} + repr(r['losses']), flush=True)"]
    return ["-c", "\n".join(lines)]


def worker_command(argv: Sequence[str]) -> List[str]:
    """A pod's interpreter arguments for the worker's own entry point."""
    return ["-m", "kubegpu_tpu_torch.models.worker", *argv]


def start_pod(command: Sequence[str], env: Optional[Dict[str, str]] = None):
    """One pod: this interpreter on ``command`` (:func:`pod_script`,
    :func:`worker_command`) from the repo's root, with the repo and the
    tests on its path and no rendezvous variable of the caller's but
    ``env``'s."""
    base = {k: v for k, v in os.environ.items()
            if k not in RENDEZVOUS_ENV and k != "PYTHONPATH"}
    base.update(PYTHONPATH=os.pathsep.join([REPO, TESTS]), **(env or {}))
    proc = subprocess.Popen([sys.executable, *command], env=base, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.started_at = time.monotonic()
    return proc


def finish(procs: Sequence, timeout_s: float) -> List[tuple]:
    """``(exit code, stdout, stderr, seconds from its start)`` of every
    process, all read at once; when one passes ``timeout_s`` every one
    is killed and AssertionError raised."""
    outs: List[Optional[tuple]] = [None] * len(procs)

    def read(i: int) -> None:
        out, err = procs[i].communicate()
        outs[i] = (procs[i].returncode, out, err,
                   time.monotonic() - procs[i].started_at)

    readers = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout_s
    try:
        for t in readers:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in readers):
            raise AssertionError(
                f"a pod ran past {timeout_s} s (hung at the rendezvous?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in readers:
            t.join(10)
    return outs


def run_commands(pods: Sequence[Sequence[str]],
                 envs: Sequence[Dict[str, str]],
                 reference: Optional[Sequence[str]] = None, *,
                 timeout_s: float = 240.0) -> List[tuple]:
    """A gang's pods (interpreter arguments ``pods[p]`` under
    ``envs[p]``) and, at the same time, one process alone on
    ``reference``; every one must exit 0.  Returns :func:`finish`'s
    tuples, the pods' and then the reference's."""
    procs = [start_pod(cmd, env) for cmd, env in zip(pods, envs)]
    if reference is not None:
        procs.append(start_pod(reference))
    outs = finish(procs, timeout_s)
    for i, (code, _, err, _) in enumerate(outs):
        assert code == 0, f"process {i} exited {code}:\n{err[-3000:]}"
    return outs


def run_pods(run: str, pods_argv: Sequence[Sequence[str]],
             envs: Sequence[Dict[str, str]],
             reference_argv: Optional[Sequence[str]] = None, *,
             fp32: bool = False, timeout_s: float = 240.0) -> List[tuple]:
    """:func:`run_commands` of ``worker.<run>`` scripts
    (:func:`pod_script`) on each pod's argv and the reference's."""
    return run_commands(
        [pod_script(run, argv, fp32=fp32) for argv in pods_argv], envs,
        None if reference_argv is None
        else pod_script(run, reference_argv, fp32=fp32),
        timeout_s=timeout_s)


def losses_of(out: str) -> List[float]:
    line = next(ln for ln in out.splitlines() if ln.startswith(LOSSES))
    return ast.literal_eval(line[len(LOSSES):])
