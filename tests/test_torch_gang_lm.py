"""The LM family's training modes in a gang of pods on the CPU: pods as
OS processes whose env is the CRI shim's ``worker_env`` (the coordinator
on loopback) join one world, and every step's loss equals one process's
``--cpu-ranks`` run over as many ranks bit for bit, since the LM family
draws its rows per data shard, not per process:

- samples/jax-lm-tp.yaml's shape: ``--model lm --tp 2`` over 2 pods of
  1 rank, in float32; each pod checkpoints into a directory of its own
  (separate disks) and only the gang's rank 0 writes; its first loss is
  also JAX's ``{"data": 1, "model": 2}`` ``make_lm_train_step``'s on the
  same weights and tokens, within 1e-5;
- samples/multi-tenant.yaml's shape: 2 pods of 2 ranks, ``--tp 2``, so
  data 2 x model 2 across the pods;
- ``lm-cp --cp 2``, ``moe --ep 2`` and ``pp``, each over 2 pods of 1
  rank.

Every pod's first rank prints ``TRAINING_MESH ... process=p/2`` and
``FIRST_STEP_DONE``."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.data import synthetic_token_batches as jax_tokens
from kubegpu_tpu.models.train import (
    TrainState as JaxTrainState,
    make_lm_train_step,
    place_lm as jax_place_lm,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import init_params, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gang_cases as pods  # noqa: E402
from test_torch_gang import gang_envs  # noqa: E402

LM = ["--device", "cpu", "--vocab", "64", "--hidden", "32", "--heads", "4",
      "--layers", "2", "--seq", "16", "--batch-per-chip", "2", "--steps",
      "3"]
CASES = {
    # (run, the gang's flags, its ranks a pod, the mesh line)
    "lm-tp": ("run_lm", ["--model", "lm", "--tp", "2"], 1,
              "data=1 model=2"),
    "lm-dp-tp": ("run_lm", ["--model", "lm", "--tp", "2"], 2,
                 "data=2 model=2"),
    "lm-cp": ("run_lm", ["--model", "lm-cp", "--cp", "2"], 1,
              "data=1 seq=2"),
    "moe": ("run_moe", ["--model", "moe", "--ep", "2"], 1,
            "data=1 expert=2 model=1"),
    "pp": ("run_pp", ["--model", "pp"], 1, "pipe=2"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gang_losses_equal_one_process_over_as_many_ranks(case, tmp_path):
    run, flags, local, mesh_line = CASES[case]
    envs = gang_envs(2, pods.free_port())
    argv = LM + flags + ["--cpu-ranks", str(local)]
    ckpt = [str(tmp_path / f"pod{p}") for p in range(2)]
    pods_argv = ([argv + ["--ckpt-dir", d] for d in ckpt]
                 if case == "lm-tp" else [argv] * 2)
    outs = pods.run_pods(run, pods_argv, envs,
                         LM + flags + ["--cpu-ranks", str(2 * local)],
                         fp32=case == "lm-tp")
    alone = pods.losses_of(outs[2][1])
    devices = ",".join(["cpu"] * 2 * local)
    for p, (_, out, _, _) in enumerate(outs[:2]):
        assert pods.losses_of(out) == alone
        assert re.search(rf"^TRAINING_MESH {mesh_line} process={p}/2 "
                         rf"devices={devices} backend=gloo", out, re.M), out
        assert "FIRST_STEP_DONE" in out
        # each pod reports its own ranks, by their global rank
        assert sorted(set(re.findall(r"^PEAK_MEM_GIB .* rank=(\d+)$", out,
                                     re.M))) == [
            str(p * local + i) for i in range(local)]
    if case == "lm-tp":
        assert "CHECKPOINT_SAVED step=3" in outs[0][1]
        assert "CHECKPOINT_SAVED" not in outs[1][1]
        assert os.listdir(os.path.join(ckpt[0], "lm")) == ["3"]
        assert not os.path.exists(os.path.join(ckpt[1], "lm")) or \
            not os.listdir(os.path.join(ckpt[1], "lm"))
        first = pods.losses_of(outs[0][1])[0]
        assert abs(first - jax_first_loss_tp2()) <= 1e-5


def jax_first_loss_tp2() -> float:
    """JAX's first ``{"data": 1, "model": 2}`` training step's loss, in
    float32 with the worker's flash attention and sequence parallelism,
    on the port worker's initial weights (``WEIGHT_SEED``, drawn on the
    CPU) and on the tokens of the worker's step 0 (its source's second
    draw: the first sizes the init)."""
    vocab, layers, hidden, heads, seq, rows = 64, 2, 32, 4, 16, 2
    cfg = dict(vocab_size=vocab, num_layers=layers, hidden=hidden,
               max_seq=seq + 1)
    params = tree_map(lambda t: jnp.asarray(t.numpy()), init_params(
        cfg, torch.Generator().manual_seed(worker.WEIGHT_SEED),
        torch.float32, "cpu"))
    model = JaxTransformerLM(dtype=jnp.float32, attn_impl="flash",
                             sequence_parallel=True, num_heads=heads, **cfg)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats={}, opt_state=tx.init(params),
                          apply_fn=model.apply, tx=tx)
    mesh = jax_device_mesh({"data": 1, "model": 2},
                           devices=jax.devices()[:2])
    # data 1: the one data shard's stream (the mesh form draws every
    # local device's shard on a host of more devices than the mesh)
    source = jax_tokens(rows, seq + 1, vocab, worker_id=0)
    next(source)
    state, tokens = jax_place_lm(state, jnp.asarray(next(source)), mesh)
    _, loss = make_lm_train_step(mesh, donate=False)(state, tokens)
    return float(loss)
