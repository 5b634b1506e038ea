"""The port's rendezvous of a gang of pods
(``parallel/mesh.py::distributed_init_from_env``, ``parallel/launch.py``'s
gang store, the worker's training modes in a gang), on the CPU with
pods as OS processes whose env is the CRI shim's ``worker_env`` (the
coordinator on loopback):

- ``distributed_init_from_env`` reads JAX's own env cases as the JAX
  function and the JAX worker read them: alone, a gang's table, or
  ValueError for a mangled table beside a coordinator;
- the north star's rule: a ``resnet-tiny`` gang of 2 pods of 1 rank
  trains on each pod's own stream, so its first loss is JAX's
  ``{"data": 2}`` step's on streams 0 and 1 in process order (float32,
  within 1e-5, from the port's initial weights), both pods report the
  same losses, and it differs from one process's ``--cpu-ranks 2`` run
  (stream 0 alone);
- pods of unequal rank counts raise in every pod, naming both counts;
  a pod that never arrives makes the other fail within the rendezvous
  timeout instead of hanging;
- the smoke's pod env is ``worker_env``'s.

The LM family's gangs are in tests/test_torch_gang_lm.py."""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.crishim.inject import worker_env
from kubegpu_tpu.models import worker as jax_worker
from kubegpu_tpu.models.data import synthetic_image_batches as jax_images
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu.parallel import mesh as jax_mesh
from kubegpu_tpu.types.info import PodInfo
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import init_resnet_params
from kubegpu_tpu_torch.models.resnet import ResNet
from kubegpu_tpu_torch.parallel.mesh import GangTable, distributed_init_from_env

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_cases as pods  # noqa: E402
from test_torch_resnet_train import jax_step  # noqa: E402
from torch_resnet_cases import numpy_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def gang_envs(n: int, port: int):
    """The shim's env for each of ``n`` pods of one gang, sorted as the
    shim sorts them, with the coordinator on loopback at ``port``."""
    names = [f"train-{i}" for i in range(n)]
    envs = [worker_env(PodInfo(name=name), names, subdomain="train-svc")
            for name in names]
    for env in envs:
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    return envs


def jax_reads(env, monkeypatch, fn=None):
    """What JAX makes of ``env``: ``jax.distributed.initialize``'s
    arguments, or None when it runs alone (``fn``: the library function
    on ``env``, default; else a callable reading ``os.environ``)."""
    called = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: called.update(kw))
    if fn is None:
        ran = jax_mesh.distributed_init_from_env(env)
        assert ran == bool(called)
    else:
        fn()
    return called or None


def port_reads(table):
    if table is None:
        return None
    assert isinstance(table, GangTable)
    return dict(coordinator_address=f"{table.host}:{table.port}",
                num_processes=table.num_processes,
                process_id=table.process_id)


ALONE_OR_GANG = {
    "empty": {},
    "one": {"JAX_NUM_PROCESSES": "1"},
    "bogus": {"JAX_NUM_PROCESSES": "bogus"},
    "no-coordinator": {"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"},
    "coordinator-alone": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476",
                          "JAX_NUM_PROCESSES": "1"},
    "gang": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476",
             "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"},
    "worker-env": gang_envs(4, 8476)[3],
}


@pytest.mark.parametrize("case", list(ALONE_OR_GANG))
def test_distributed_init_from_env_reads_the_env_as_jax(case, monkeypatch):
    env = ALONE_OR_GANG[case]
    got = port_reads(distributed_init_from_env(env, timeout_s=7.0))
    assert got == jax_reads(env, monkeypatch)
    if got is not None:
        assert distributed_init_from_env(env, timeout_s=7.0).timeout_s == 7.0


@pytest.mark.parametrize("mangled", [
    {"JAX_NUM_PROCESSES": "four"},
    {"JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "x"},
])
def test_a_mangled_table_beside_a_coordinator_raises_as_in_jax(mangled,
                                                              monkeypatch):
    env = dict(mangled, JAX_COORDINATOR_ADDRESS="10.0.0.1:8476")
    with pytest.raises(ValueError, match="malformed") as jax_error:
        jax_reads(env, monkeypatch)
    with pytest.raises(ValueError, match="malformed") as port_error:
        distributed_init_from_env(env)
    assert str(port_error.value) == str(jax_error.value)


def test_the_process_id_falls_back_on_tpu_worker_id_as_the_jax_worker(
        monkeypatch):
    env = {"JAX_COORDINATOR_ADDRESS": "train-0.svc:8476",
           "JAX_NUM_PROCESSES": "2", "TPU_WORKER_ID": "1"}
    for k in pods.RENDEZVOUS_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jax_reads(None, monkeypatch, jax_worker.initialize_distributed)
    assert port_reads(distributed_init_from_env()) == want
    assert port_reads(worker.pod_gang()) == want


def test_the_smokes_pod_env_is_worker_envs():
    """The smoke's pods run on the port's CRI shim's injection: JAX's
    ``worker_env`` for the same gang, its coordinator the first pod's
    hostname (a loopback address) at the free port the smoke passes,
    and card 0's UUID in both visibility variables."""
    from kubegpu_tpu_torch.plugins.fake import FakeGpuHost

    host = FakeGpuHost("gpu-node", cards=1)
    port = pods.free_port()
    envs = chip_smoke.gang_pod_envs("jax-resnet", 4, host.provider(), port)
    names = [o["metadata"]["name"]
             for o in chip_smoke.gang_pods("jax-resnet", 4, "gpu-node")]
    assert names == ["127.0.0.1", "127.0.0.2", "127.0.0.3", "127.0.0.4"]
    for i, env in enumerate(envs):
        want = worker_env(PodInfo(name=names[i], pod_group="jax-resnet"),
                          names, coordinator_port=port)
        assert {k: env[k] for k in want} == want
        assert env["JAX_COORDINATOR_ADDRESS"] == f"127.0.0.1:{port}"
        assert env["JAX_PROCESS_ID"] == env["TPU_WORKER_ID"] == str(i)
        assert env["CUDA_VISIBLE_DEVICES"] == host.uuids[0]
        assert env["NVIDIA_VISIBLE_DEVICES"] == host.uuids[0]
        assert set(env) == set(want) | {"CUDA_VISIBLE_DEVICES",
                                        "NVIDIA_VISIBLE_DEVICES"}
        assert distributed_init_from_env(env).process_id == i


# the north star's rule at the CI twin's size
RESNET = ["--model", "resnet-tiny", "--device", "cpu", "--steps", "2",
          "--batch-per-chip", "2"]


def test_resnet_gang_trains_on_each_pods_stream_as_jaxs_gang():
    """Each pod draws ``--batch-per-chip`` rows from its own process id's
    stream, as a JAX process does; one process of two ranks draws both
    halves from stream 0, as one JAX host of two devices does."""
    envs = gang_envs(2, pods.free_port())
    outs = pods.run_pods("run_resnet", [RESNET] * 2, envs,
                         RESNET + ["--cpu-ranks", "2"], fp32=True)
    gang = [pods.losses_of(out) for _, out, _, _ in outs[:2]]
    alone = pods.losses_of(outs[2][1])
    assert gang[0] == gang[1]
    for p, (_, out, _, _) in enumerate(outs[:2]):
        assert re.search(rf"^TRAINING_MESH data=2 process={p}/2 "
                         r"devices=cpu,cpu backend=gloo$", out, re.M)
        assert "FIRST_STEP_DONE" in out

    b = 2
    draws = []
    for p in range(2):
        source = jax_images(b, size=32, num_classes=10, worker_id=p)
        next(source)  # the init batch; step 0 trains on the next
        draws.append(next(source))
    images = np.concatenate([im for im, _ in draws])
    labels = np.concatenate([lb for _, lb in draws])
    model = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10,
                   dtype=torch.float32, image_size=32)
    params, stats = init_resnet_params(
        model, torch.Generator().manual_seed(worker.WEIGHT_SEED), "cpu")
    want = jax_step(numpy_tree(params), numpy_tree(stats), None, images,
                    labels, "sgd",
                    device_mesh({"data": 2}, devices=jax.devices()[:2]))
    assert abs(gang[0][0] - want["loss"]) <= 1e-5
    assert abs(gang[0][0] - alone[0]) > 1e-3


LM = ["--model", "lm", "--device", "cpu", "--vocab", "64", "--hidden", "32",
      "--heads", "4", "--layers", "1", "--seq", "16", "--batch-per-chip",
      "2", "--steps", "1"]


def test_pods_of_unequal_rank_counts_raise_in_every_pod():
    envs = gang_envs(2, pods.free_port())
    procs = [pods.start_pod(pods.pod_script("run_lm", LM + [
        "--cpu-ranks", str(p + 1)]), env) for p, env in enumerate(envs)]
    for p, (code, _, err, _) in enumerate(pods.finish(procs, 120.0)):
        assert code != 0
        assert re.search(rf"process {p} holds {p + 1} rank\(s\) and process "
                         rf"{1 - p} holds {2 - p}", err), err[-2000:]


RENDEZVOUS_TIMEOUT_S = 3.0


@pytest.mark.parametrize("present", [0, 1])
def test_a_pod_that_never_arrives_fails_the_other_within_the_timeout(present):
    """Pod ``present`` alone of a gang of two: as process 0 it serves the
    store and waits for process 1's rank count; as process 1 it cannot
    reach the coordinator.  Either way it raises after the rendezvous
    timeout given to ``distributed_init_from_env``."""
    env = gang_envs(2, pods.free_port())[present]
    proc = pods.start_pod(pods.pod_script(
        "run_lm", LM + ["--tp", "2"], timeout_s=RENDEZVOUS_TIMEOUT_S), env)
    (code, _, err, took), = pods.finish([proc], 120.0)
    assert code != 0
    assert ("did not arrive within 3.0 s" in err if present == 0
            else "timed out" in err), err[-2000:]
    # the interpreter's start and torch's import come on top of the wait
    assert RENDEZVOUS_TIMEOUT_S <= took <= RENDEZVOUS_TIMEOUT_S + 60
