"""Worker of the port: ``--model resnet50`` (the default),
``resnet50-unrolled`` and ``resnet-tiny`` (data-parallel ResNet
training), ``--model decode`` (serving), ``--model lm`` and ``--model
lm-cp`` (LM training), ``--model moe`` (expert-parallel MoE training)
and ``--model pp`` (pipeline-parallel LM training).

The port of ``kubegpu_tpu/models/worker.py``.  ``--model resnet50``
trains the scan-rolled ResNet-50 (``resnet50-unrolled``: every block its
own module; ``resnet-tiny``: one bottleneck a stage, 8 filters, 10
classes at 32 px, the CI twin), as the JAX worker's ``_run_resnet``:
bf16 compute over float32 weights drawn fresh from ``WEIGHT_SEED``
(flax's initializers), nesterov SGD (``--optimizer adam`` too), on
``--batch-per-chip`` ``--image-size`` images of ``--num-classes``
classes a step from the JAX worker's synthetic image stream (``--data
synthetic|stream|resident``).  Over n devices (the cards, or
``--cpu-ranks`` with ``--device cpu``) it trains over a ``{"data": n}``
mesh, one process a rank, NCCL between cards or gloo on the CPU: the
global batch is ``--batch-per-chip`` x n, every BatchNorm reduces over
it, and step i takes the rows the JAX worker's step i takes on a host
of n devices (each rank draws that host's batch and keeps its rows).

A pod that the CRI shim's env makes one of a gang of P pods
(``JAX_NUM_PROCESSES`` above 1, ``JAX_COORDINATOR_ADDRESS``,
``JAX_PROCESS_ID``) joins one world with the other pods in every
training mode, as the JAX worker joins ``jax.distributed``: its L local
devices are global ranks ``process_id x L .. + L - 1`` of a mesh over
all P x L devices, met at the coordinator's store (gloo when two ranks
share a card or sit on the CPU, NCCL otherwise).  Each pod's ResNet
draws its own ``--batch-per-chip`` x L rows from its process id's
stream, as a JAX process does; the LM family draws per data shard.
Each pod's first rank prints its ``TRAINING_MESH``, ``FIRST_STEP_DONE``
and ``steady_state`` lines and its ranks' launch and peak lines; only
the gang's rank 0 writes checkpoints.  A malformed table, or a count
above 1 with no coordinator, raises SystemExit.  The serving modes
ignore the table: a replica serves alone.
It prints ``FIRST_STEP_DONE seconds= loss=`` and ``steady_state
images_per_sec= loss=``, the kernels' launch counts (all 0: no kernel of
the port is on this path) and the peak device memory; ``--ckpt-dir``
checkpoints under ``DIR/<model>``, the BatchNorm statistics included.

    python -m kubegpu_tpu_torch.models.worker --steps 100
    python -m kubegpu_tpu_torch.models.worker --model resnet-tiny \
        --cpu-ranks 2 --device cpu --steps 3

In decode mode it builds the LM at the given
widths with fresh weights drawn from a fixed seed (bf16 unless
``--serve-fp32``; ``--int8`` serves weight-only int8 weights, printing
``SERVING_INT8``) and serves them as ``--serving`` says:

- ``static`` (the default, as in the JAX worker): ``greedy_generate``
  over one aligned batch of ``--batch-per-chip`` prompts of
  ``--prompt-len`` tokens drawn from ``np.random.RandomState(1)``,
  ``--steps`` tokens each: one warm call, then ``FIRST_DECODE_DONE
  seconds=``, three timed calls and ``DECODE_DONE tokens_per_sec=
  ms_per_call=``; ``--serve`` repeats the call forever, printing
  ``SERVING tokens_per_sec=`` every 50 calls;
- ``continuous``: :class:`ContinuousBatcher`, slot-based continuous
  batching over a dense per-slot cache (chunked prefill at 128 rows);
- ``paged``: :class:`PagedContinuousBatcher`, continuous batching over a
  shared KV page pool and the paged attention kernels (K1, K2);
- ``speculative``: :class:`SpeculativeContinuousBatcher`, the dense slot
  batcher with a fresh draft of ``--draft-layers`` layers proposing
  ``--spec-k`` tokens a verify.

The three batchers serve one warm-up wave and one timed wave of the JAX
worker's requests: ``2 x --batch-per-chip`` prompts of random length in
``[1, --prompt-len]`` from ``np.random.RandomState(0)``, budgets cycling
``1/4 .. 1 x --steps``; then ``FIRST_DECODE_DONE`` and ``DECODE_DONE
tokens_per_sec= serving= requests= steps= admits=``, and the kernels'
launch counts (the dense modes launch none of them).  ``--serve``
replays waves forever after the timed one, printing ``SERVING
tokens_per_sec=`` per wave.  Paged-only knobs: ``--speculate`` serves
greedy speculative decoding through the pool (a verify window, K2,
scores the draft's tokens; the streams are the non-speculative ones at
fp32); ``--kv-dtype int8`` stores the pool (and the draft ring) as int8
pages with per-page, per-head scales, read by K1q/K2q;
``--decode-page-cache`` lets retirement seal decode-produced pages into
the prefix chain.  ``--sample-temperature T`` samples the batchers'
waves instead of taking the argmax, as the JAX worker does: request i of
a wave pins seed ``--sample-seed + i``, ``--sample-top-k`` truncates to
the k most likely tokens, and the speculative modes run
rejection-sampled speculation.

    python -m kubegpu_tpu_torch.models.worker --model decode \\
        --vocab 32768 --hidden 4096 --heads 32 --layers 4 --seq 1023 \\
        --prompt-len 128 --batch-per-chip 8 --steps 256 [--int8]
    python -m kubegpu_tpu_torch.models.worker --model decode \\
        --serving paged|continuous|speculative --prompt-len 128 \\
        --batch-per-chip 8 --steps 64 [--speculate] [--kv-dtype int8] \\
        [--sample-temperature 0.8 [--sample-top-k 50] [--sample-seed 0]]

``--serve-http PORT`` (``--serving paged`` or ``continuous``) serves the
batcher as a replica HTTP endpoint instead (``gateway/dataplane.py``,
the JAX replica's wire schema): it builds the batcher, warms every
kernel and path it runs, then prints ``REPLICA_HTTP_SERVING port=N
serving=S role=R tls=0|1 seconds=S`` and serves ``POST /v1/submit``
(SSE), ``POST /v1/cancel``, the migration verbs ``POST /v1/export``,
``/v1/import`` and ``/v1/role`` (a dense batcher answers them as the JAX
replica does, without migration), ``GET /v1/state``, ``GET /healthz``
and ``GET /metrics`` until SIGTERM, when it prints
``REPLICA_HTTP_STOPPED`` and exits 0.  ``--role prefill|decode|flex`` is
the replica's disaggregation role (``prefill`` parks each sequence at its
seal for the gateway's handoff), ``--serve-http-fail-migration`` refuses
every import (a chaos knob), ``--serve-http-tls-cert/-key`` serve HTTPS,
``--serve-http-auth-token-file`` gates ``/v1/*`` behind a bearer token,
``--serve-http-step-delay`` slows the loop (a test knob).

    python -m kubegpu_tpu_torch.models.worker --model decode --serving paged \\
        --serve-http 0 [--role prefill] [--speculate] [--kv-dtype int8]

``--tp N`` (``--serving paged``, N above 1) serves tensor-parallel, as
the JAX worker's mesh: it prints ``SERVING_TP tp=N devices=...
backend=...``, starts ranks 1..N-1 as processes and is rank 0 itself,
on ``cuda:0..N-1`` over NCCL, or on the CPU over gloo with ``--device
cpu``; each rank holds ``1/N`` of every page's heads and its Megatron
shard of the weights, rank 0 drives the wave or the HTTP replica and
the other ranks replay its calls (``parallel/replay.py``).  The counts
it prints are rank 0's.  It refuses N above the visible card count, and
heads, vocab or draft heads that do not split N ways.

    python -m kubegpu_tpu_torch.models.worker --model decode \\
        --serving paged --tp 2 [--serve-http 0] [--device cpu]

The JAX worker's refusals hold: ``--kv-dtype`` and ``--tp`` above 1 need
``--serving paged`` (the dense batchers run on one device), and
``--serve-http`` refuses ``static`` and ``speculative``.

``--ckpt-dir DIR`` serves what ``--model lm --ckpt-dir DIR`` trained:
the parameters of the latest ``DIR/lm`` step (``models/checkpoint.py``;
``tools/orbax_to_torch_checkpoint.py`` converts the JAX worker's Orbax
steps), cast on the device, printing ``RESTORED_FOR_SERVING step=N``;
``--int8`` quantizes them and ``--tp`` shards them after the restore.
``--draft-ckpt-dir`` restores the speculative draft the same way, in
bf16 as the JAX worker casts it (``RESTORED_DRAFT_FOR_SERVING``).  With
no checkpoint there the worker warns and serves fresh weights, as the
JAX worker does; a checkpoint of another width or depth raises.

    python -m kubegpu_tpu_torch.models.worker --model decode \
        --serving paged --ckpt-dir /ckpt [--speculate --draft-ckpt-dir /draft]

``--model lm`` trains ``TransformerLM`` (bf16 compute over float32
weights drawn fresh from seed 0; ``--optimizer sgd``, nesterov SGD at
lr 0.1, the default, or ``adam`` at 3e-4) on the JAX worker's
synthetic token stream, ``--batch-per-chip`` windows of ``--seq + 1``
tokens a step.  With ``--ckpt-dir DIR`` it resumes from the latest
``DIR/lm`` step (``RESUMED step=N``; every rank of a mesh restores its
own shard, and the stream skips the batches already trained on, so a
resumed run continues as the uninterrupted run would), saves every
``--ckpt-every`` steps (the seconds left out of ``steady_state``) and
saves the last step at the end (``CHECKPOINT_SAVED step=N``).  It prints the JAX worker's ``FIRST_STEP_DONE`` and
``steady_state tokens_per_sec=`` lines, then the launch counts of the
flash-attention kernels (K3 forward, K4 and K5 backward; with ``--remat``
K3 runs twice a layer) and the peak device memory.  ``--attn-impl flash``
(the default) runs those kernels, ``einsum`` the model-dtype einsum
attention; ``ring`` and ``ulysses`` run flash too (no ``"seq"`` axis
here), as in the JAX worker.

    python -m kubegpu_tpu_torch.models.worker --model lm --vocab 32768 \\
        --hidden 4096 --heads 32 --layers 4 --seq 1024 \\
        --batch-per-chip 16 --steps 5

Over several devices ``--model lm`` trains data x tensor-parallel, as
the JAX worker's ``_split_mesh``: of the n visible devices (the cards,
or with ``--device cpu`` the ``--cpu-ranks`` it is told to stand in for
them, default 1) ``--tp`` (0: all n) make the ``"model"`` axis and n /
tp the ``"data"`` axis, one process a rank (rank 0 is the worker, which
starts the others), over NCCL on ``cuda:0..n-1`` or gloo on the CPU,
with sequence parallelism.  Each data rank trains on its
``--batch-per-chip`` rows of the global batch (``--batch-per-chip`` x
dp rows) from its own data shard's stream.  Rank 0 prints a
``TRAINING_MESH data=.. model=.. devices=.. backend=..`` line, the
global tokens/s and each rank's launch counts and peak memory.  The JAX
refusals hold: ``--tp`` must divide n, and heads and vocab split tp ways
(and, with sequence parallelism, ``--seq``).

    python -m kubegpu_tpu_torch.models.worker --model lm --tp 2 \\
        --cpu-ranks 4 --device cpu [--vocab 64 --hidden 32 --heads 4 ...]

``--model lm-cp`` trains the context-parallel LM, as the JAX worker
does: ``--cp`` (0: all n devices) ranks make the ``"seq"`` axis and n /
cp the ``"data"`` axis of a ``("data", "seq")`` mesh, one process a rank
even at one device (the ``{"data": 1, "seq": 1}`` mesh, whose ring has
one diagonal block), NCCL between cards, gloo on the CPU.  Every rank
holds the whole weights; each of a data row's cp ranks trains on its
``--seq / cp`` rows of that row's ``--batch-per-chip`` windows.
``--attn-impl flash`` (the default) runs ring attention, ``ring``,
``ulysses`` and ``einsum`` run as named.  Rank 0 prints
``TRAINING_MESH data=.. seq=.. devices=.. backend=.. attn_impl=..``,
then the lines of ``--model lm`` and each rank's ``CP_BYTES`` (the
bytes its ring hops and all-to-alls sent, and those staged through the
host).  ``--cp`` must divide n, and ``--seq`` must divide by cp
(Ulysses: ``--heads`` too); ``--tp`` is not read.  ``--ckpt-dir``
checkpoints under ``DIR/lm-cp``.

    python -m kubegpu_tpu_torch.models.worker --model lm-cp --cp 2 \\
        --seq 64 --cpu-ranks 4 --device cpu [--attn-impl ulysses ...]

``--model moe`` trains the MoE transformer (``models/moe.py``) as the
JAX worker does: capacity factor 2.0, einsum attention (the JAX worker
passes no ``--attn-impl`` to it), ``--moe-router top1|top2|
expert_choice`` and ``--moe-dispatch einsum|gather``, ``--num-experts``
experts (0: one a ``"expert"`` rank), weights drawn fresh from seed 0
with flax's initializers.  Of the n visible devices ``--tp`` (0: no
tensor parallelism) make the ``"model"`` axis, and of the n / tp left
``--ep`` (0: all of them) the ``"expert"`` axis and the rest ``"data"``:
a ``{"data": dp, "expert": ep[, "model": tp]}`` mesh, one process a
rank, over NCCL between cards or gloo on the CPU (``--cpu-ranks``).
Each rank holds its experts (and under ``--tp`` its Megatron shard of
them and of the attention, embeddings and head); every rank of a data
row trains on that row's ``--batch-per-chip`` windows.  Rank 0 prints
``TRAINING_MESH data=.. expert=.. model=.. devices=.. backend=..`` and
the lines of ``--model lm``.  The JAX refusals
hold: ``--tp`` and ``--ep`` must divide, heads split tp ways (and here
vocab and hidden too), and the experts ep ways.  ``--ckpt-dir``
checkpoints under ``DIR/moe``.

    python -m kubegpu_tpu_torch.models.worker --model moe --ep 2 \
        --cpu-ranks 2 --device cpu [--tp 2 --cpu-ranks 4] \
        [--moe-router top2 --moe-dispatch gather]

``--model pp`` trains the pipelined LM (``models/pipeline_lm.py``) as
the JAX worker's ``_run_pp``: ``--pp-stages`` (0: every visible device)
stages on a ``{"pipe": stages}`` mesh of the first devices, one process
a stage (rank 0 the worker, which starts the others; NCCL between
cards, gloo on the CPU with ``--cpu-ranks``), ``--pp-rounds`` rounds of
the circular schedule (1: GPipe), ``--microbatches`` microbatches a
step; ``--layers`` counts layers a STAGE, so the model has ``stages x
rounds x layers`` layers.  Float32 weights drawn fresh from seed 0 (no
dtype: float32 compute), SGD at lr 0.1 with momentum 0.9 and no
Nesterov whatever ``--optimizer`` says, ``--batch-per-chip`` x
``--microbatches`` windows a step, the same on every stage (the worker
id does not enter the seed).  Rank 0 prints ``TRAINING_MESH pipe=..
devices=.. backend=..`` over a mesh, the lines of ``--model lm`` (every
kernel count 0: the blocks' attention is einsum) and each stage's
``PP_BYTES`` (the bytes its hops sent and staged through the host).
The JAX refusals hold: ``--pp-stages`` must divide the devices, and the
circular schedule needs ``--microbatches`` >= stages; ``--ckpt-dir`` is
ignored with a warning, and nothing is saved.

    python -m kubegpu_tpu_torch.models.worker --model pp --cpu-ranks 2 \
        --device cpu [--pp-rounds 2 --microbatches 4] [--vocab 64 ...]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (the kernels are then never launched).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubegpu_tpu_torch.models.data import (
    device_pool_batches,
    prefetch_to_device,
    synthetic_image_batches,
    synthetic_token_batches,
    synthetic_token_batches_for_mesh,
)
from kubegpu_tpu_torch.models.decoding import (
    greedy_generate,
    quantize_params_int8,
)
from kubegpu_tpu_torch.models.moe import (
    DISPATCH_IMPLS,
    ROUTERS,
    MoeTransformerLM,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.pipeline_lm import (
    PipelineLM,
    init_pipeline_lm,
    pipeline_lm_step,
    place_pipeline_lm,
    to_circular_layout,
)
from kubegpu_tpu_torch.models.params import (
    bf16_cast,
    init_moe_params,
    init_params,
    init_resnet_params,
    resolve_device,
)
from kubegpu_tpu_torch.models.resnet import ResNet, ResNet50, ScanResNet50
from kubegpu_tpu_torch.models.serving import (
    DECODE_PAGE_CACHE_POLICIES,
    KV_DTYPES,
    ContinuousBatcher,
    load_draft_checkpoint,
    resolve_kv_dtype,
)
from kubegpu_tpu_torch.models.spec_serving import SpeculativeContinuousBatcher
from kubegpu_tpu_torch.models.checkpoint import (
    make_manager,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from kubegpu_tpu_torch.models.train import (
    OPTIMIZERS,
    adam,
    create_train_state,
    lm_step,
    moe_step,
    place_cp_lm,
    place_lm,
    place_moe,
    place_resnet,
    resnet_step,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.ops import _build
from kubegpu_tpu_torch.ops.attention import (
    flash_backward_delta,
    flash_backward_dkdv,
    flash_backward_dq,
    flash_forward,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
)
from kubegpu_tpu_torch.parallel.launch import (
    check_local_counts,
    gang_backend,
    join_ranks,
    open_gang_store,
    open_host_gang,
    open_store,
    start_ranks,
)
from kubegpu_tpu_torch.parallel.collectives import CP_TRAFFIC, gather_objects
from kubegpu_tpu_torch.parallel.mesh import (
    GangTable,
    close_mesh,
    device_mesh,
    distributed_init_from_env,
)
from kubegpu_tpu_torch.utils.metrics import Metrics

log = logging.getLogger("kubegpu_tpu_torch.worker")

WEIGHT_SEED = 0
RESNET_MODELS = ("resnet50", "resnet50-unrolled", "resnet-tiny")
TRAINING_MODELS = RESNET_MODELS + ("moe", "pp", "lm", "lm-cp")
# the JAX worker's MoE capacity factor
MOE_CAPACITY_FACTOR = 2.0
# the ResNets' compute dtype (the JAX ResNet's default)
RESNET_DTYPE = torch.bfloat16
# the draft's weights come from their own seed (the JAX worker's draft
# init uses PRNGKey(7))
DRAFT_SEED = 7


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=list(RESNET_MODELS)
                    + ["decode", "lm", "lm-cp", "moe", "pp"],
                    default="resnet50",
                    help="resnet50 (the default: scan-rolled), "
                    "resnet50-unrolled, resnet-tiny = data-parallel "
                    "ResNet training; decode = serving; lm = LM "
                    "training; lm-cp = context-parallel LM training "
                    "(ring/ulysses); moe = expert-parallel MoE training; "
                    "pp = GPipe-pipelined LM training")
    ap.add_argument("--serving",
                    choices=["static", "continuous", "paged", "speculative"],
                    default="static",
                    help="decode: static = aligned-batch greedy generate "
                    "(the default); continuous = slot-based continuous "
                    "batching over a dense per-slot cache; paged = "
                    "continuous batching over a shared KV page pool; "
                    "speculative = draft-verified continuous batching over "
                    "dense caches")
    ap.add_argument("--steps", type=int, default=20,
                    help="decode: budget of the longest request; "
                    "training: steps")
    ap.add_argument("--batch-per-chip", type=int, default=32,
                    help="decode: slots (a wave holds twice as many "
                    "requests); lm: token windows a step; pp: token "
                    "windows a microbatch; resnet: images a step a device")
    ap.add_argument("--image-size", type=int, default=224,
                    help="resnet50, resnet50-unrolled: image side "
                    "(resnet-tiny trains at 32)")
    ap.add_argument("--num-classes", type=int, default=1000,
                    help="resnet50, resnet50-unrolled: classes "
                    "(resnet-tiny has 10)")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--layers", type=int, default=4,
                    help="LM layers (pp: layers PER STAGE)")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--seq", type=int, default=1024,
                    help="the LM's training window (lm trains on seq+1 "
                    "token windows); the cache holds seq+1 rows")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt (prompt-len + steps must fit seq + 1)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page rows (must divide --prompt-len); default "
                    "128 when it divides, else the whole prompt pad")
    ap.add_argument("--serve-fp32", action="store_true",
                    help="serve float32 weights instead of the bf16 cast")
    ap.add_argument("--speculate", action="store_true",
                    help="greedy speculative decoding through the page "
                    "pool: a draft proposes --spec-k tokens, one verify "
                    "window scores them")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="--speculate and --serving speculative: draft "
                    "proposals per verify window")
    ap.add_argument("--int8", action="store_true",
                    help="decode: serve weight-only int8 (per-output-channel "
                    "scales)")
    ap.add_argument("--kv-dtype", default=None, choices=list(KV_DTYPES),
                    help="decode: the page pool's storage; default full width "
                    "at the serving dtype, int8 = per-page per-head scaled "
                    "int8 pages read by K1q/K2q (bf16/fp32 must match the "
                    "serving dtype)")
    ap.add_argument("--decode-page-cache", default="off",
                    choices=list(DECODE_PAGE_CACHE_POLICIES),
                    help="decode: seal retired sequences' decode-produced "
                    "pages into the prefix cache; off = prompt pages only, "
                    "fp32 = only on a float32 full-width pool, quantized = "
                    "only on an int8 pool, all = always")
    ap.add_argument("--sample-temperature", type=float, default=0.0,
                    help="decode: sample with this temperature instead of "
                    "the argmax (0 = greedy); with --speculate the verify "
                    "runs rejection-sampled speculation")
    ap.add_argument("--sample-top-k", type=int, default=0,
                    help="decode --sample-temperature: sample from the k "
                    "most likely tokens (0 = the full softmax)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="decode --sample-temperature: request i of a wave "
                    "pins seed sample-seed + i, so sampled streams repeat "
                    "across reruns, replicas, slots and batches")
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--draft-hidden", type=int, default=0,
                    help="draft width (0 = max(hidden // 4, 128)); its "
                    "heads are draft-hidden // 128")
    ap.add_argument("--attn-impl", default="flash",
                    choices=["einsum", "flash", "ring", "ulysses"],
                    help="lm: flash = the hand-written flash-attention "
                    "kernels, einsum = model-dtype einsum attention, ring "
                    "and ulysses = flash (no 'seq' axis); lm-cp: ring (the "
                    "default, as flash), ulysses or einsum over the 'seq' "
                    "axis")
    ap.add_argument("--remat", action="store_true",
                    help="lm: recompute each block in the backward")
    ap.add_argument("--tp", type=int, default=0,
                    help="decode --serving paged: tensor-parallel ranks (0 "
                    "or 1: one device; N: cuda:0..N-1 over NCCL, or N CPU "
                    "processes over gloo with --device cpu); lm: the "
                    "'model' axis of a (data, model) mesh over the visible "
                    "devices (0: all of them), data = devices / tp; moe: 0 "
                    "= no TP, N > 1 Megatron-shards each expert's FFN (and "
                    "the attention, embeddings, head) over N devices")
    ap.add_argument("--ep", type=int, default=0,
                    help="moe: the 'expert' axis over the devices left "
                    "after --tp (0: all of them), data = the rest")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="moe: expert count (0 = one per ep shard)")
    ap.add_argument("--moe-router", default="top1", choices=list(ROUTERS),
                    help="moe: routing (top2 drops far fewer tokens under "
                    "imbalance; expert_choice is dropless by construction "
                    "but not causal)")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=list(DISPATCH_IMPLS),
                    help="moe: token movement, dense one-hot einsums or "
                    "index-form gathers (expert_choice always einsum)")
    ap.add_argument("--cp", type=int, default=0,
                    help="lm-cp: the 'seq' axis of a (data, seq) mesh over "
                    "the visible devices (0: all of them), data = devices "
                    "/ cp")
    ap.add_argument("--pp-stages", type=int, default=0,
                    help="pp: pipeline stages (0 = all devices)")
    ap.add_argument("--pp-rounds", type=int, default=1,
                    help="pp: rounds of the circular/interleaved schedule "
                    "(1 = GPipe; V > 1 holds V stage slices per device, "
                    "bubble (P-1)/(V*M+P-1))")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pp: microbatches per step (circular needs >= "
                    "stages)")
    ap.add_argument("--cpu-ranks", type=int, default=1,
                    help="training --device cpu: the CPU's stand-in for "
                    "the visible device count (ranks of the training "
                    "mesh, processes over gloo); only with --device cpu")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "stream", "resident"],
                    help="training: synthetic = a pool of --data-pool "
                    "distinct batches on the device; stream = pinned, "
                    "prefetched host-to-device copies; resident = one "
                    "constant batch (resnet: images of ones, labels 0)")
    ap.add_argument("--data-pool", type=int, default=8,
                    help="training --data synthetic: distinct batches to "
                    "cycle")
    ap.add_argument("--serve", action="store_true",
                    help="decode: replay waves forever after the timed one "
                    "(default: a warm-up wave and a timed wave, then exit)")
    ap.add_argument("--serve-http", type=int, default=None, metavar="PORT",
                    help="decode: serve as a replica HTTP endpoint on this "
                    "port (0 = ephemeral; the chosen port prints as "
                    "REPLICA_HTTP_SERVING) — POST /v1/submit streams "
                    "committed token batches as SSE, /v1/cancel frees pages, "
                    "/v1/state, /healthz and /metrics answer the gateway")
    ap.add_argument("--role", choices=("prefill", "decode", "flex"),
                    default="flex",
                    help="--serve-http: this replica's role in a "
                    "disaggregated fleet: 'prefill' parks sequences when "
                    "their prompt pages seal (the gateway hands them off "
                    "over /v1/export -> /v1/import), 'decode' advertises a "
                    "handoff target, 'flex' serves both phases; POST "
                    "/v1/role changes it at run time")
    ap.add_argument("--serve-http-step-delay", type=float, default=0.0,
                    metavar="S",
                    help="--serve-http: sleep this long between serving "
                    "iterations (0 = flat out); slows the loop so cancels "
                    "land provably mid-stream")
    ap.add_argument("--serve-http-fail-migration", action="store_true",
                    help="--serve-http: refuse POST /v1/import (a chaos "
                    "knob: a refused import leaves both pools as they "
                    "were)")
    ap.add_argument("--serve-http-tls-cert", default=None, metavar="PEM",
                    help="--serve-http: serve HTTPS with this certificate "
                    "(pair with --serve-http-tls-key)")
    ap.add_argument("--serve-http-tls-key", default=None, metavar="PEM",
                    help="PEM private key for --serve-http-tls-cert")
    ap.add_argument("--serve-http-auth-token-file", default=None,
                    metavar="FILE",
                    help="--serve-http: require 'Authorization: Bearer "
                    "<token>' (the file's contents) on every /v1/* verb; "
                    "/healthz and /metrics stay open")
    ap.add_argument("--ckpt-dir",
                    default=os.environ.get("KUBEGPU_CKPT_DIR", ""),
                    help="checkpoint/resume root (shared across the gang); "
                    "empty disables.  Checkpoints are written under "
                    "<dir>/<model> so variants with different param "
                    "layouts never collide on resume; decode serves the "
                    "latest <dir>/lm step")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between saves")
    ap.add_argument("--draft-ckpt-dir", default="",
                    help="checkpoint root for the DRAFT model (<dir>/lm "
                    "layout, like --ckpt-dir); empty = fresh-init draft")
    ap.add_argument("--optimizer", choices=list(OPTIMIZERS), default="sgd",
                    help="training: sgd = nesterov SGD at lr 0.1 "
                    "(momentum 0.9, "
                    "the JAX default), adam = Adam at lr 3e-4 (b1 0.9, b2 "
                    "0.999, eps 1e-8); pp trains with SGD at lr 0.1, "
                    "momentum 0.9, no Nesterov, as the JAX worker")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def training_devices(args: argparse.Namespace) -> int:
    """The device count a training mesh spans: this pod's
    (:func:`local_devices`), times the pods of its gang
    (:func:`pod_gang`)."""
    gang = pod_gang()
    return local_devices(args) * (1 if gang is None else gang.num_processes)


def local_devices(args: argparse.Namespace) -> int:
    """The visible device count of this pod: the cards, or ``--cpu-ranks``
    with ``--device cpu`` (refused on the card)."""
    if args.device == "cuda":
        resolve_device("cuda")  # raises without a card
        if args.cpu_ranks != 1:
            raise SystemExit(
                f"--cpu-ranks {args.cpu_ranks}: the CPU's stand-in for the "
                "visible device count, only with --device cpu (the card "
                "machine counts its cards)")
        n = torch.cuda.device_count()
    else:
        n = args.cpu_ranks
    if n < 1:
        raise SystemExit(f"--cpu-ranks {n}: at least one rank")
    return n


def _split_mesh(n: int, parallel: int, axis: str) -> Tuple[int, int]:
    """``(data, parallel)`` axis sizes for ``n`` devices with
    ``parallel``-way model/expert/seq parallelism (0: all of them), the
    JAX worker's, which also refuses a width above ``n`` as such."""
    p = parallel or n
    if p > n:
        raise SystemExit(f"--{axis} {p} exceeds the visible device count {n}")
    if n % p:
        raise SystemExit(f"--{axis} {p} does not divide the device count {n}")
    return n // p, p


def training_mesh(args: argparse.Namespace) -> Tuple[int, int]:
    """``(dp, tp)`` of ``--model lm`` or ``(dp, cp)`` of ``--model
    lm-cp``: :func:`_split_mesh` of the visible devices
    (:func:`training_devices`) and the JAX worker's refusals."""
    n = training_devices(args)
    if args.model == "lm-cp":
        dp, cp = _split_mesh(n, args.cp, "cp")
        if args.seq % cp:
            raise SystemExit(f"--seq {args.seq} not divisible by cp={cp}")
        if args.attn_impl == "ulysses" and args.heads % cp:
            raise SystemExit(
                f"--heads {args.heads} not divisible by cp={cp} (ulysses "
                "scatters the heads over the 'seq' axis)")
        return dp, cp
    dp, tp = _split_mesh(n, args.tp, "tp")
    if args.heads % tp:
        raise SystemExit(f"--heads {args.heads} not divisible by tp={tp}")
    if args.vocab % tp:
        raise SystemExit(
            f"--vocab {args.vocab} not divisible by tp={tp} (lm_head is "
            "column-parallel over the vocab)")
    if args.seq % tp:
        raise SystemExit(
            f"--seq {args.seq} not divisible by tp={tp} (sequence "
            "parallelism puts seq / tp positions on each rank)")
    return dp, tp


def moe_mesh(args: argparse.Namespace) -> Dict[str, int]:
    """The axes of ``--model moe``'s mesh, the JAX worker's: ``--tp``
    (0: none) of the visible devices (:func:`training_devices`), then
    :func:`_split_mesh` of the rest by ``--ep`` (0: all of them), with
    its refusals; ``{"data": dp, "expert": ep}`` plus ``"model": tp``
    under ``--tp``."""
    n = training_devices(args)
    _, tp = _split_mesh(n, max(args.tp, 1), "tp")
    dp, ep = _split_mesh(n // tp, args.ep, "ep")
    experts = args.num_experts or ep
    if experts % ep:
        raise SystemExit(f"--num-experts {experts} not divisible by ep={ep}")
    axes = {"data": dp, "expert": ep}
    if tp > 1:
        for flag, v in (("heads", args.heads), ("vocab", args.vocab),
                        ("hidden", args.hidden)):
            if v % tp:
                raise SystemExit(f"--{flag} {v} not divisible by tp={tp}")
        axes["model"] = tp
    return axes


def pp_stages(args: argparse.Namespace) -> int:
    """``--model pp``'s stage count, the JAX worker's: ``--pp-stages``
    (0: all of them) of the visible devices (:func:`training_devices`),
    with its refusals."""
    n = training_devices(args)
    stages = args.pp_stages or n
    if n % stages:
        raise SystemExit(f"--pp-stages {stages} does not divide {n} devices")
    if pod_gang() is not None and stages != n:
        # a sub-mesh would leave some pods of the gang with no stage
        raise SystemExit(
            f"--pp-stages {stages} != device count {n}: in a multi-process "
            "gang the pipeline must span every device")
    rounds = max(args.pp_rounds, 1)
    if rounds > 1 and args.microbatches < stages:
        raise SystemExit(
            f"--pp-rounds {rounds} (circular schedule) needs "
            f"--microbatches >= stages ({args.microbatches} < {stages})")
    return stages


def cp_attn_impl(args: argparse.Namespace) -> str:
    """The attention of ``--model lm-cp``: ``flash`` runs as ``ring``,
    as in the JAX worker."""
    return "ring" if args.attn_impl == "flash" else args.attn_impl


def wave_requests(rng: np.random.RandomState, n_req: int, vocab: int,
                  prompt_len: int) -> List[np.ndarray]:
    """One wave's prompts, drawn exactly as the JAX worker draws them."""
    return [
        rng.randint(0, vocab, size=rng.randint(1, prompt_len + 1),
                    dtype=np.int32)
        for _ in range(n_req)
    ]


def draft_shape(args: argparse.Namespace) -> tuple:
    """The draft's ``(hidden, heads)``: ``--draft-hidden`` (0 =
    ``max(hidden // 4, 128)``) in heads of 128."""
    d_hidden = args.draft_hidden or max(args.hidden // 4, 128)
    return d_hidden, max(d_hidden // 128, 1)


def draft_for(args: argparse.Namespace, max_seq: int, device,
              announce: bool = True):
    """The draft of ``--speculate``, ``--draft-layers`` deep and
    ``--draft-hidden`` wide with heads of 128, as the JAX worker sizes
    it: restored from ``--draft-ckpt-dir`` when it holds a checkpoint
    (:func:`load_draft_checkpoint`, bf16 as the JAX worker casts it,
    printing ``RESTORED_DRAFT_FOR_SERVING`` when ``announce``), else
    fresh weights from ``DRAFT_SEED`` (bf16 unless ``--serve-fp32``;
    with ``--draft-ckpt-dir`` a warning says so).  Also enforces the
    speculation headroom rule: a verify window writes rows ``[pos, pos +
    k]``, so the cache needs k rows past prompt plus budget.  Returns
    ``(params, heads, hidden)``."""
    if args.prompt_len + args.steps + args.spec_k > max_seq:
        raise SystemExit(
            f"--prompt-len {args.prompt_len} + --steps {args.steps} + "
            f"--spec-k {args.spec_k} exceeds --seq+1 = {max_seq}: the "
            "speculative verify window needs k rows of cache headroom"
        )
    d_hidden, d_heads = draft_shape(args)
    if d_hidden % d_heads:
        raise SystemExit(
            f"--draft-hidden {d_hidden} not divisible by its derived "
            f"head count {d_heads} (heads are d_hidden//128; pick a "
            "multiple of 128)"
        )
    if args.draft_ckpt_dir:
        dparams = load_draft_checkpoint(
            args.draft_ckpt_dir, vocab_size=args.vocab,
            num_layers=args.draft_layers, num_heads=d_heads,
            hidden=d_hidden, max_seq=max_seq, device=device)
        if dparams is not None:
            if announce:
                print("RESTORED_DRAFT_FOR_SERVING", flush=True)
            return dparams, d_heads, d_hidden
        log.warning("no draft checkpoint under %s; speculating with a fresh "
                    "draft init (lossless, but accept rate will be ~0)",
                    args.draft_ckpt_dir)
    cfg = dict(vocab_size=args.vocab, num_layers=args.draft_layers,
               hidden=d_hidden, max_seq=max_seq)
    gen = torch.Generator(device=device).manual_seed(DRAFT_SEED)
    dparams = init_params(cfg, gen, torch.float32, device)
    if not args.serve_fp32:
        dparams = bf16_cast(dparams)
    return dparams, d_heads, d_hidden


def check_serving_knobs(args: argparse.Namespace) -> None:
    """The JAX worker's refusals of knobs a serving mode does not take:
    tensor parallelism and the KV storage format are the paged batcher's,
    and ``--tp`` must fit the visible cards and split the heads and the
    vocab."""
    if args.tp > 1 and args.serving == "static":
        raise SystemExit(
            f"--tp {args.tp} with --serving static: tensor-parallel "
            "serving is the paged batcher's mesh (--serving paged)"
        )
    if args.tp > 1 and args.serving != "paged":
        raise SystemExit(
            f"--tp {args.tp} with --serving {args.serving}: tensor-"
            "parallel serving is the PAGED batcher's mesh (--serving "
            "paged); dense/speculative batchers are single-device"
        )
    if args.kv_dtype is not None and args.serving != "paged":
        raise SystemExit(
            f"--kv-dtype {args.kv_dtype} with --serving {args.serving}: "
            "the KV storage format is the PAGED pool's knob "
            "(--serving paged)"
        )
    if args.tp > 1:
        check_tp(args)
    if args.prompt_len + args.steps > args.seq + 1:
        raise SystemExit(
            f"--prompt-len {args.prompt_len} + --steps {args.steps} exceeds "
            f"the cache size --seq+1 = {args.seq + 1}"
        )
    try:
        # a contradictory pair (e.g. --kv-dtype bf16 with --serve-fp32)
        # dies here, like the other geometry checks
        resolve_kv_dtype(args.kv_dtype,
                         torch.float32 if args.serve_fp32 else torch.bfloat16)
    except ValueError as e:
        raise SystemExit(str(e))


def check_tp(args: argparse.Namespace) -> None:
    """``--tp N``'s refusals, as the JAX worker's: no more ranks than
    visible cards (on the card), heads and vocab split N ways."""
    if args.device == "cuda":
        n = torch.cuda.device_count()
        if args.tp > n:
            raise SystemExit(
                f"--tp {args.tp} exceeds the visible device count {n}")
    if args.heads % args.tp:
        raise SystemExit(f"--heads {args.heads} not divisible by "
                         f"tp={args.tp}")
    if args.vocab % args.tp:
        raise SystemExit(
            f"--vocab {args.vocab} not divisible by tp={args.tp} (lm_head "
            "is column-parallel over the vocab)")
    d_hidden, d_heads = draft_shape(args)
    if args.speculate and d_heads % args.tp:
        raise SystemExit(
            f"draft head count {d_heads} (derived from --draft-hidden "
            f"{d_hidden} // 128) not divisible by tp={args.tp}: pick "
            f"--draft-hidden = a multiple of {128 * args.tp}")


def tp_devices(args: argparse.Namespace,
               n: Optional[int] = None) -> List[str]:
    """Each of ``n`` (default ``--tp``) ranks' device: ``cuda:r``, or the
    CPU for every rank."""
    n = args.tp if n is None else n
    if args.device == "cpu":
        return ["cpu"] * n
    return [f"cuda:{r}" for r in range(n)]


# an HTTP replica's ranks wait for rank 0's next call as long as it idles
TP_IDLE_TIMEOUT_S = 30 * 24 * 3600.0


def join_tp_mesh(args: argparse.Namespace, rank: int, store_path: str):
    """Rank ``rank``'s mesh of ``--tp`` ranks: NCCL between cards, gloo
    on the CPU."""
    devices = tp_devices(args)
    return device_mesh(args.tp, rank,
                       backend="gloo" if args.device == "cpu" else "nccl",
                       device=devices[rank],
                       store=open_store(store_path, args.tp),
                       idle_timeout_s=TP_IDLE_TIMEOUT_S,
                       devices=tuple(devices))


def _tp_follower(rank: int, args: argparse.Namespace,
                 store_path: str) -> None:
    """Rank ``rank`` (> 0) of ``--tp``: build the same batcher and replay
    rank 0's calls on it until rank 0 closes it."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = join_tp_mesh(args, rank, store_path)
    try:
        build_batcher(args, mesh).follow()
    finally:
        close_mesh(mesh)


def open_batcher(args: argparse.Namespace):
    """:func:`build_batcher` after the knob checks, with ``--tp``'s
    other ranks started first (:class:`TPRanks`, None at one device).
    Returns ``(batcher, ranks)``."""
    check_serving_knobs(args)
    ranks = TPRanks(args) if args.tp > 1 else None
    return build_batcher(args, ranks and ranks.mesh), ranks


class TPRanks:
    """``--tp N``'s ranks 1..N-1, started as processes, and rank 0's
    mesh (this process).  ``close`` releases the followers of ``cb``,
    joins them, leaves the mesh, and raises if a rank failed."""

    def __init__(self, args: argparse.Namespace) -> None:
        self._dir = tempfile.mkdtemp(prefix="kubegpu-tp-")
        store = os.path.join(self._dir, "store")
        self.procs = start_ranks(_tp_follower, range(1, args.tp), args, store)
        self.mesh = join_tp_mesh(args, 0, store)
        print(f"SERVING_TP tp={args.tp} devices="
              + ",".join(self.mesh.devices)
              + f" backend={self.mesh.backend}", flush=True)

    def close(self, cb) -> None:
        cb.close()
        codes = join_ranks(self.procs)
        close_mesh(self.mesh)
        shutil.rmtree(self._dir, ignore_errors=True)
        if any(codes):
            raise RuntimeError(f"tensor-parallel ranks 1..{len(codes)} "
                               f"exited with {codes}")


def serving_params(args: argparse.Namespace, device, announce: bool = True):
    """The served weights at the given widths, bf16 unless
    ``--serve-fp32``: with ``--ckpt-dir``, the parameter leaves of the
    latest ``<dir>/lm`` step (written by ``--model lm``; the optimizer
    state is not read), cast leaf by leaf on the device, printing
    ``RESTORED_FOR_SERVING step=N``; without one, or when ``<dir>/lm``
    holds no checkpoint (a warning says so), fresh from ``WEIGHT_SEED``.
    The checkpoint's ``pos_embed`` is sized ``--seq + 1``; another width
    or depth raises.  ``--int8`` quantizes after the restore (whole,
    before any tensor-parallel sharding).  ``announce`` prints the
    lines.  Returns ``(params, model config, dtype)``."""
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               num_heads=args.heads, hidden=args.hidden, max_seq=args.seq + 1)
    dtype = torch.float32 if args.serve_fp32 else torch.bfloat16
    params = None
    if args.ckpt_dir:
        mgr = make_manager(os.path.join(os.path.abspath(args.ckpt_dir), "lm"))
        restored = restore_params(mgr, cfg, device=device, dtype=dtype)
        if restored is not None:
            params, step = restored
            if announce:
                print(f"RESTORED_FOR_SERVING step={step}", flush=True)
        else:
            log.warning("no lm checkpoint under %s; serving fresh weights",
                        args.ckpt_dir)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
        params = init_params(cfg, gen, torch.float32, device)
        if not args.serve_fp32:
            params = bf16_cast(params)
    if args.int8:
        params = quantize_params_int8(params)
        if announce:
            print("SERVING_INT8 weight-only per-output-channel", flush=True)
    return params, cfg, dtype


def build_batcher(args: argparse.Namespace, mesh=None):
    """The worker's batcher for ``--serving continuous|paged|speculative``
    over :func:`serving_params`' weights, ``--batch-per-chip`` slots and
    prompts up to ``--prompt-len``.  The paged pool holds every slot's
    ``--prompt-len + --steps`` rows (plus ``--spec-k`` rows of verify
    headroom when speculating).  ``mesh``: this rank's share of a
    ``--tp`` batcher, on the mesh's device."""
    check_serving_knobs(args)
    if args.serving == "static":
        raise SystemExit("--serving static decodes through greedy_generate "
                         "and builds no batcher")
    device = resolve_device(args.device if mesh is None else mesh.device)
    max_seq = args.seq + 1
    page = None
    if args.serving == "paged":
        if args.page_size is not None:
            if args.page_size < 1 or args.prompt_len % args.page_size:
                raise SystemExit(
                    f"--page-size {args.page_size} must be positive and "
                    f"divide --prompt-len {args.prompt_len} (whole-page "
                    "admit scatter)"
                )
            page = args.page_size
        else:
            page = 128 if args.prompt_len % 128 == 0 else args.prompt_len
    params, cfg, dtype = serving_params(
        args, device, announce=mesh is None or mesh.rank == 0)
    slots = args.batch_per_chip
    common = dict(cfg, slots=slots, prompt_pad=args.prompt_len, dtype=dtype,
                  device=device, quant=args.int8)
    sample_kw = dict(sampling=args.sample_temperature > 0,
                     top_k=args.sample_top_k)
    if args.serving == "continuous":
        return ContinuousBatcher(params, **common, top_k=args.sample_top_k)
    announce = mesh is None or mesh.rank == 0
    if args.serving == "speculative":
        # greedy output equals the dense batcher's for any draft, only
        # the verify count moves
        dparams, d_heads, d_hidden = draft_for(args, max_seq, device)
        return SpeculativeContinuousBatcher(
            params, dparams, **common, k=args.spec_k,
            draft_num_layers=args.draft_layers, draft_num_heads=d_heads,
            draft_hidden=d_hidden, **sample_kw)
    spec_kw = {}
    k_extra = 0
    if args.speculate:
        dparams, d_heads, d_hidden = draft_for(args, max_seq, device,
                                               announce)
        spec_kw = dict(draft_params=dparams, speculate_k=args.spec_k,
                       draft_num_layers=args.draft_layers,
                       draft_num_heads=d_heads, draft_hidden=d_hidden)
        k_extra = args.spec_k  # per-sequence page-reservation headroom
    pool = slots * -(-(args.prompt_len + args.steps + k_extra) // page) + 1
    return PagedContinuousBatcher(
        params, **common, page_size=page, pool_pages=pool,
        kv_dtype=args.kv_dtype, decode_page_cache=args.decode_page_cache,
        mesh=mesh,
        # sampled traffic keeps speculation: the verify rejection-samples
        **sample_kw, **spec_kw,
    )


def sampled_wave_kw(args: argparse.Namespace, n_req: int) -> dict:
    """The ``run`` arguments of a sampled wave, as the JAX worker's: every
    request at ``--sample-temperature``, request i pinning seed
    ``--sample-seed + i``; empty when the worker decodes greedily."""
    if args.sample_temperature <= 0:
        return {}
    return dict(temperatures=[args.sample_temperature] * n_req,
                seeds=[args.sample_seed + i for i in range(n_req)])


def warm_batcher(cb, temperature: float = 0.0) -> None:
    """Pay every first-use cost before traffic: serve two full-length
    prompts, one after the other, so every program the batcher runs
    executes once (the second samples at ``temperature`` when it is
    above 0).  For the paged batcher it builds the kernel libraries
    first, and the two prompts share their full pages, so the station
    prefill, the page scatter, the prefix gather, the decode step (K1)
    or the draft scan and verify (K2) and retirement sealing all run;
    for the dense batcher the chunked prefill and the step run.  The
    batcher's stats (and step ledger) are reset after, so they count
    served traffic only."""
    paged = isinstance(cb, PagedContinuousBatcher)
    if paged and cb.device.type == "cuda":
        _build.build()
    prompt = (np.arange(cb.prompt_pad, dtype=np.int32) * 7 + 1) % (
        cb.model.vocab_size)
    budget = max(1, min(2, cb.max_seq - cb.prompt_pad
                        - (getattr(cb, "speculate_k", None) or 0)))
    for seq, temp in ((0, 0.0), (1, temperature)):
        cb.submit(seq, prompt, budget, temp, seed=0 if temp > 0 else None)
        while cb.has_work():
            cb.serve_step()
    if cb.device.type == "cuda":
        torch.cuda.synchronize(cb.device)
    cb._reset_stats()
    if paged:
        cb._ledger.clear()


def kernel_counters() -> Dict[str, tuple]:
    """Every kernel of the port by its ID, as (wrapper, launch counter
    attribute): the paged attention kernels and the flash kernels."""
    return {"K1": (paged_decode_attention, "launches"),
            "K1q": (paged_decode_attention, "int8_launches"),
            "K2": (paged_chunk_attention, "launches"),
            "K2q": (paged_chunk_attention, "int8_launches"),
            "K3": (flash_forward, "launches"),
            "K4": (flash_backward_dkdv, "launches"),
            "K5": (flash_backward_dq, "launches")}


def read_counters() -> Dict[str, int]:
    return {k: getattr(fn, a) for k, (fn, a) in kernel_counters().items()}


def run_static(args: argparse.Namespace, report=None) -> Dict[str, object]:
    """``--serving static``: the JAX worker's aligned-batch decode —
    ``greedy_generate`` over one ``(--batch-per-chip, --prompt-len)``
    prompt from ``np.random.RandomState(1)``, ``--steps`` tokens each.
    One warm call (its end is ``first_decode_s`` after the start), then
    three timed calls.  With ``--serve`` it hands the result to
    ``report`` and then repeats the call forever, printing ``SERVING
    tokens_per_sec=`` every 50 calls."""
    t0 = time.monotonic()
    check_serving_knobs(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, cfg, dtype = serving_params(args, device)
    batch = args.batch_per_chip
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, args.vocab, size=(batch, args.prompt_len)).astype(np.int32)).to(
        device)
    launches0 = read_counters()

    def call():
        return greedy_generate(params, prompt, args.steps, **cfg,
                               dtype=dtype, quant=args.int8, device=device)

    out = call()
    int(out[0, -1])  # a value readback forces the call to its end
    first_s = time.monotonic() - t0
    n = 3
    ts = time.monotonic()
    for _ in range(n):
        out = call()
    int(out[0, -1])
    dt = (time.monotonic() - ts) / n
    launches = {k: v - launches0[k] for k, v in read_counters().items()}
    result = {
        "first_decode_s": first_s,
        "tokens": batch * args.steps,
        "tokens_per_sec": batch * args.steps / dt,
        "ms_per_call": dt * 1e3,
        "launches": launches,
        "outputs": out,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "device": str(device),
    }
    if args.serve:
        if report is not None:
            report(result)
        calls = 0
        ts = time.monotonic()
        while True:
            out = call()
            int(out[0, -1])
            calls += 1
            if calls % 50 == 0:
                now = time.monotonic()
                print(f"SERVING tokens_per_sec="
                      f"{50 * batch * args.steps / (now - ts):.1f}",
                      flush=True)
                ts = now
    return result


def run_decode(args: argparse.Namespace,
               report=None) -> Dict[str, object]:
    """Serve ``--serving``'s decode and return what was measured (the
    CLI prints it): ``static`` is :func:`run_static`; the batchers serve
    a warm-up wave and a timed wave.  With ``--serve`` it hands the
    result to ``report`` and then replays waves forever, printing
    ``SERVING tokens_per_sec=`` after each."""
    if args.serving == "static":
        return run_static(args, report)
    t0 = time.monotonic()
    cb, ranks = open_batcher(args)
    try:
        return _serve_waves(args, cb, t0, report)
    finally:
        if ranks is not None:
            ranks.close(cb)


def _serve_waves(args: argparse.Namespace, cb, t0: float,
                 report) -> Dict[str, object]:
    device = cb.device
    slots = args.batch_per_chip
    rng = np.random.RandomState(0)
    n_req = 2 * slots
    budgets = [max(args.steps * (1 + i % 4) // 4, 1) for i in range(n_req)]
    run_kw = sampled_wave_kw(args, n_req)
    launches0 = read_counters()

    def wave():
        prompts = wave_requests(rng, n_req, args.vocab, args.prompt_len)
        tw = time.monotonic()
        out = cb.run(prompts, budgets, **run_kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.monotonic() - tw

    out, _ = wave()  # warm-up: first-use costs (kernel build, allocator)
    steps = cb.stats["steps"]
    spec_steps = cb.stats.get("spec_steps", 0)
    first_s = time.monotonic() - t0
    out, dt = wave()
    steps += cb.stats["steps"]
    spec_steps += cb.stats.get("spec_steps", 0)
    ttft = sorted(getattr(cb, "first_token_s", {}).values())
    total = sum(len(v) for v in out.values())
    launches = {k: v - launches0[k] for k, v in read_counters().items()}
    paged = isinstance(cb, PagedContinuousBatcher)
    result = {
        "first_decode_s": first_s,
        "tokens": total,
        "tokens_per_sec": total / dt,
        "wave_s": dt,
        "requests": n_req,
        "steps": cb.stats["steps"],
        "admits": cb.stats["admits"],
        "decode_steps_total": steps,
        "layers": args.layers,
        "launches": launches,
        "k1_launches": launches["K1"],
        "k1q_launches": launches["K1q"],
        "k2_launches": launches["K2"],
        "k2q_launches": launches["K2q"],
        "kv_dtype": (cb.kv_dtype if paged
                     else str(cb.dtype).replace("torch.", "")),
        "pool_bytes": (cb.pool_kv_bytes + cb.pool_scale_bytes if paged
                       else None),
        "cache_bytes": cache_bytes(cb),
        "tp": getattr(cb, "tp", 1),
        "pool_bytes_per_device": getattr(cb, "pool_bytes_per_device", None),
        "spec_steps": cb.stats.get("spec_steps", 0),
        "spec_tokens": cb.stats.get("spec_tokens", 0),
        "draft_wraps": cb.stats.get("draft_wraps", 0),
        "spec_steps_total": spec_steps,
        "ttft_mean_s": float(np.mean(ttft)) if ttft else None,
        "ttft_max_s": ttft[-1] if ttft else None,
        "outputs": out,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "device": str(device),
    }
    if args.serve:
        if report is not None:
            report(result)
        while True:
            out, dt = wave()
            total = sum(len(v) for v in out.values())
            print(f"SERVING tokens_per_sec={total / dt:.1f}", flush=True)
    return result


def cache_bytes(cb) -> int:
    """The KV bytes a batcher rests: the paged pool (pages and scales),
    or the dense per-slot caches (and a speculative batcher's draft
    caches)."""
    if isinstance(cb, PagedContinuousBatcher):
        return cb.pool_kv_bytes + cb.pool_scale_bytes
    caches = list(cb.caches) + list(getattr(cb, "d_caches", []))
    return sum(t.numel() * t.element_size() for kv in caches for t in kv)


def serve_http(args: argparse.Namespace, t0: float) -> int:
    """``--serve-http``: expose the batcher as a replica HTTP endpoint
    (``gateway/dataplane.py``) until SIGTERM.  The device is checked
    (``build_batcher`` raises without a card unless ``--device cpu``)
    and every kernel warmed before the port is bound and advertised."""
    import signal
    import threading

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer

    if args.serving not in ("continuous", "paged"):
        raise SystemExit(
            f"--serve-http with --serving {args.serving}: the replica "
            "HTTP endpoint drives the incremental serving API "
            "(submit/serve_step/cancel) — use --serving continuous or "
            "--serving paged"
        )
    if bool(args.serve_http_tls_cert) != bool(args.serve_http_tls_key):
        raise SystemExit(
            "--serve-http-tls-cert and --serve-http-tls-key must be given "
            "together")
    auth_token = None
    if args.serve_http_auth_token_file:
        with open(args.serve_http_auth_token_file) as f:
            auth_token = f.read().strip()
    cb, ranks = open_batcher(args)
    warm_batcher(cb, args.sample_temperature)
    metrics = Metrics()
    cb.attach_metrics(metrics)
    launches0 = read_counters()
    server = ReplicaServer(
        cb, listen=("0.0.0.0", args.serve_http), metrics=metrics,
        step_delay_s=args.serve_http_step_delay,
        fail_migration=args.serve_http_fail_migration,
        tls_cert=args.serve_http_tls_cert, tls_key=args.serve_http_tls_key,
        auth_token=auth_token, role=args.role,
    ).start()
    print(f"REPLICA_HTTP_SERVING port={server.port} serving={args.serving} "
          f"role={server.loop.role} tls={int(server.tls)} "
          f"seconds={time.monotonic() - t0:.2f}", flush=True)
    shutdown = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: shutdown.set())
    try:
        # a timed wait, so the main thread runs the signal handler
        while not shutdown.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()
    if ranks is not None:
        ranks.close(cb)
    launches = " ".join(f"{k}_LAUNCHES={v - launches0[k]}"
                        for k, v in read_counters().items())
    print(f"REPLICA_HTTP_STOPPED steps={cb.stats['steps']} "
          f"admits={cb.stats['admits']} layers={args.layers} {launches} "
          f"error={server.loop.error is not None}", flush=True)
    return 0 if server.loop.error is None else 1


def make_batches(args: argparse.Namespace, source, device, resident=None):
    """The ``--data`` modes, as the JAX worker's ``_make_batches``:
    returns ``(batches, first)`` with ``batches`` None in resident mode,
    where ``first`` is the constant batch (``resident()``, default the
    source's first batch).  The JAX worker sizes its init with the first
    batch of a pool or stream; taking it here too keeps step i on the
    JAX worker's batch i."""
    if args.data == "synthetic":
        batches = device_pool_batches(source, device,
                                      pool=max(args.data_pool, 1))
        return batches, next(batches)
    if args.data == "stream":
        batches = prefetch_to_device(source, device, depth=2)
        return batches, next(batches)
    if resident is not None:
        return None, resident()
    return None, torch.from_numpy(next(source)).to(device)


def worker_id() -> int:
    """This worker's index in its gang, read as the JAX worker reads it
    from the injected env (``JAX_PROCESS_ID``, else ``TPU_WORKER_ID``,
    else 0): it seeds the worker's image stream."""
    return int(os.environ.get("JAX_PROCESS_ID",
                              os.environ.get("TPU_WORKER_ID", "0")) or 0)


def pod_gang() -> Optional[GangTable]:
    """The gang of pods the injected env makes this training worker one
    of (:func:`distributed_init_from_env`), or None when it runs alone.
    Raises SystemExit where the JAX worker's rendezvous fails: a
    ``JAX_NUM_PROCESSES`` that is not a count, a count above 1 with no
    ``JAX_COORDINATOR_ADDRESS``, a mangled table beside a
    coordinator."""
    raw = os.environ.get("JAX_NUM_PROCESSES", "1") or "1"
    try:
        num = int(raw)
    except ValueError:
        raise SystemExit(f"JAX_NUM_PROCESSES={raw!r} is not a count")
    if num > 1 and not os.environ.get("JAX_COORDINATOR_ADDRESS"):
        raise SystemExit(
            f"JAX_NUM_PROCESSES={num} with no JAX_COORDINATOR_ADDRESS: a "
            "gang of pods needs its coordinator")
    try:
        return distributed_init_from_env()
    except ValueError as e:
        raise SystemExit(str(e))


def resnet_model(args: argparse.Namespace, mesh=None):
    """The ``--model``'s ResNet at ``RESNET_DTYPE``, as the JAX worker
    builds it: ``resnet50`` scan-rolled, ``resnet50-unrolled``, and
    ``resnet-tiny`` (one bottleneck a stage, 8 filters) forcing 10
    classes at 32 px, so its labels come from the head's label space.
    The model records its image size (``image_size``)."""
    if args.model == "resnet-tiny":
        return ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                      num_classes=10, dtype=RESNET_DTYPE, mesh=mesh,
                      image_size=32)
    cls = ScanResNet50 if args.model == "resnet50" else ResNet50
    return cls(num_classes=args.num_classes, dtype=RESNET_DTYPE, mesh=mesh,
               image_size=args.image_size)


def build_resnet_trainer(args: argparse.Namespace, mesh=None):
    """The ResNet's training state and batch source: fresh float32
    weights and statistics from ``WEIGHT_SEED`` (every rank of a mesh
    draws the same ones), ``--optimizer``, the ``--data`` mode's
    ``(images, labels)`` batches.  Each of a pod's L ranks draws the
    pod's batch of ``--batch-per-chip`` x L rows from the worker's
    stream (a process of L devices in the JAX worker, seeded by its
    process id) and keeps the rows of its local rank: on one host the
    host's batch, in a gang each pod's its own.  The resident batch is
    the JAX worker's images of ones and labels 0.  Returns ``(state,
    next_batch)``, a batch an ``(images, labels)`` pair."""
    device = resolve_device(args.device if mesh is None else mesh.device)
    model = resnet_model(args, mesh)
    size, classes = model.image_size, model.num_classes
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    params, stats = init_resnet_params(model, gen, device)
    optimizer = sgd() if args.optimizer == "sgd" else adam()
    state = place_resnet(model, params, stats, optimizer=optimizer,
                         mesh=mesh)
    del params, stats  # the state holds its own copies
    rows = max(args.batch_per_chip, 1)
    n = 1 if mesh is None else mesh.local_size
    first = rows * (0 if mesh is None else mesh.local_rank)
    host = synthetic_image_batches(rows * n, size=size, num_classes=classes,
                                   worker_id=worker_id())
    source = ((im[first:first + rows], lb[first:first + rows])
              for im, lb in host)
    batches, const = make_batches(args, source, device, resident=lambda: (
        torch.ones((rows, size, size, 3), device=device),
        torch.zeros((rows,), dtype=torch.int32, device=device)))

    def next_batch():
        return const if batches is None else next(batches)

    return state, next_batch


def build_moe_trainer(args: argparse.Namespace, mesh=None):
    """``--model moe``'s training state and batch source, as
    :func:`build_trainer`'s: fresh float32 weights from ``WEIGHT_SEED``
    (every rank of a mesh draws the whole tree and keeps its shard,
    ``place_moe``), bf16 compute, einsum attention, ``--num-experts``
    (0: the mesh's ``"expert"`` width), the JAX worker's capacity factor,
    ``--moe-router``/``--moe-dispatch``, ``--optimizer``, this data
    shard's rows of the ``--data`` mode's batches.  Returns ``(state,
    next_batch)``."""
    if args.hidden % args.heads:
        raise SystemExit(f"--hidden {args.hidden} not divisible by --heads "
                         f"{args.heads}")
    device = resolve_device(args.device if mesh is None else mesh.device)
    experts = args.num_experts or (1 if mesh is None
                                   else mesh.axis_size("expert"))
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               hidden=args.hidden, max_seq=args.seq + 1,
               num_experts=experts)
    model = MoeTransformerLM(**cfg, num_heads=args.heads,
                             capacity_factor=MOE_CAPACITY_FACTOR,
                             dtype=torch.bfloat16, remat=args.remat,
                             router_type=args.moe_router,
                             dispatch_impl=args.moe_dispatch, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    tree = init_moe_params(cfg, gen, device)
    optimizer = sgd() if args.optimizer == "sgd" else adam()
    state = place_moe(model, tree, optimizer=optimizer, mesh=mesh)
    del tree  # the state holds its own copies or shards
    rows = max(args.batch_per_chip, 1)
    if mesh is None:
        source = synthetic_token_batches(rows, args.seq + 1, args.vocab)
    else:
        source = synthetic_token_batches_for_mesh(
            rows * mesh.axis_size("data"), args.seq + 1, args.vocab, mesh)
    batches, const = make_batches(args, source, device)

    def next_batch():
        return const if batches is None else next(batches)

    return state, next_batch


def build_pp_trainer(args: argparse.Namespace, mesh=None):
    """``--model pp``'s training state and batch source, as the JAX
    worker's ``_run_pp``: ``stages x --pp-rounds`` stages of ``--layers``
    layers (``stages`` the mesh's ``"pipe"`` width, 1 without a mesh),
    ``max_seq`` ``--seq + 1``, fresh float32 weights from ``WEIGHT_SEED``
    (every rank draws the whole tree and keeps its stage,
    ``place_pipeline_lm``; circular layout under ``--pp-rounds``),
    non-Nesterov SGD, and ``--batch-per-chip`` x ``--microbatches``
    windows a step, the same on every rank.  Returns ``(state,
    next_batch)``."""
    if args.hidden % args.heads:
        raise SystemExit(f"--hidden {args.hidden} not divisible by --heads "
                         f"{args.heads}")
    device = resolve_device(args.device if mesh is None else mesh.device)
    stages = 1 if mesh is None else mesh.axis_size("pipe")
    rounds = max(args.pp_rounds, 1)
    micro = max(args.microbatches, 1)
    cfg = dict(vocab_size=args.vocab, num_stages=stages * rounds,
               layers_per_stage=args.layers, hidden=args.hidden,
               max_seq=args.seq + 1)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    tree = init_pipeline_lm(gen, **cfg, device=device)
    if rounds > 1:
        tree = to_circular_layout(tree, stages)
    model = PipelineLM(**cfg, num_heads=args.heads, num_microbatches=micro,
                       num_rounds=rounds, mesh=mesh)
    state = place_pipeline_lm(model, tree, optimizer=sgd(nesterov=False))
    del tree  # the state holds its own copies or stages
    # the stream is replicated over "pipe": every rank draws the same bytes
    source = synthetic_token_batches(max(args.batch_per_chip, 1) * micro,
                                     args.seq + 1, args.vocab)
    batches, const = make_batches(args, source, device)

    def next_batch():
        return const if batches is None else next(batches)

    return state, next_batch


def build_trainer(args: argparse.Namespace, mesh=None):
    """The worker's training state and batch source at the given widths:
    fresh float32 weights from ``WEIGHT_SEED``, bf16 compute,
    ``--optimizer``, the ``--data`` mode's batches.  Over a ``mesh`` every rank draws
    the whole tree on its device and keeps its shard (``place_lm``), so
    every width trains the weights one device trains, and draws its data
    shard's rows.  ``--model lm-cp`` builds the context-parallel model over
    its ``("data", "seq")`` mesh, every rank keeping the whole tree
    (``place_cp_lm``).  Returns ``(state, next_batch)``."""
    if args.hidden % args.heads:
        raise SystemExit(f"--hidden {args.hidden} not divisible by --heads "
                         f"{args.heads}")
    device = resolve_device(args.device if mesh is None else mesh.device)
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               hidden=args.hidden, max_seq=args.seq + 1)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    cp = args.model == "lm-cp"
    model = TransformerLM(**cfg, num_heads=args.heads, dtype=torch.bfloat16,
                          sequence_parallel=not cp,
                          attn_impl=cp_attn_impl(args) if cp
                          else args.attn_impl,
                          remat=args.remat, context_parallel=cp, mesh=mesh)
    tree = init_params(cfg, gen, torch.float32, device)
    optimizer = sgd() if args.optimizer == "sgd" else adam()
    if mesh is None:
        state = create_train_state(model, tree, optimizer=optimizer)
        source = synthetic_token_batches(max(args.batch_per_chip, 1),
                                         args.seq + 1, args.vocab)
    else:
        place = place_cp_lm if cp else place_lm
        state = place(model, tree, optimizer=optimizer)
        del tree  # the whole tree: only this rank's copy or shard stays
        source = synthetic_token_batches_for_mesh(
            max(args.batch_per_chip, 1) * mesh.axis_size("data"),
            args.seq + 1, args.vocab, mesh)
    batches, const = make_batches(args, source, device)

    def next_batch():
        return const if batches is None else next(batches)

    return state, next_batch


class CheckpointHooks:
    """``--ckpt-dir``'s checkpoints of ``--model lm`` (the JAX worker's
    ``_CheckpointHooks``), under ``<dir>/<model>`` so other layouts never
    collide.  Building it warns of legacy step directories at the root
    (never restored), restores the latest step into the fresh ``state``
    (every rank its own shard) and prints ``RESUMED step=N``;
    :meth:`maybe_save` saves every ``--ckpt-every`` steps and
    :meth:`finish` saves the final step unless it was just saved, then
    prints ``CHECKPOINT_SAVED step=N``.  Over a mesh every rank calls
    every method; ``lead`` (the global rank 0, the one that writes)
    prints.  The seconds of the restore
    and of each save, and the last step's bytes, are kept for the
    report."""

    def __init__(self, args: argparse.Namespace, state, lead: bool) -> None:
        root = os.path.abspath(args.ckpt_dir)
        self.lead = lead
        try:
            legacy = sorted(
                d for d in os.listdir(root)
                if d.isdigit() and os.path.isdir(os.path.join(root, d)))
        except OSError:
            legacy = []
        if legacy and lead:
            # checkpoints at the root predate per-model namespacing; their
            # layout may not match this model, so they are not restored,
            # but silence would look like a silent restart from step 0
            log.warning(
                "ignoring legacy checkpoints at %s (steps %s); checkpoints "
                "now live under %s — restore manually if the layouts match",
                root, ",".join(legacy), os.path.join(root, args.model))
        self.mgr = make_manager(os.path.join(root, args.model))
        self.last_saved = -1
        self.save_s: List[float] = []
        ts = time.monotonic()
        restored = restore_checkpoint(self.mgr, state)
        self.restore_s = time.monotonic() - ts if restored else None
        self.start_step = state.step if restored else 0
        if restored is not None and lead:
            print(f"RESUMED step={self.start_step}", flush=True)

    def save(self, state) -> float:
        ts = time.monotonic()
        self.last_saved = save_checkpoint(self.mgr, state)
        self.save_s.append(time.monotonic() - ts)
        return self.save_s[-1]

    def maybe_save(self, state, done: int, every: int) -> float:
        if every <= 0 or done % every != 0:
            return 0.0
        return self.save(state)

    def finish(self, state) -> None:
        if state.step != self.last_saved:
            self.save(state)
        if self.lead:
            print(f"CHECKPOINT_SAVED step={state.step}", flush=True)

    def report(self) -> Dict[str, object]:
        step = self.mgr.latest_step()
        return dict(resumed_step=self.start_step or None,
                    restore_s=self.restore_s, save_s=list(self.save_s),
                    ckpt_step=step,
                    ckpt_bytes=(self.mgr.nbytes(step) if self.lead
                                and step is not None else None),
                    ckpt_dir=self.mgr.directory)


def _train(args: argparse.Namespace, mesh, t0: float) -> Dict[str, object]:
    """Train ``--steps`` steps on this rank (the only one without a
    mesh).  Each pod's first rank (the reporter; rank 0 on one host)
    prints ``FIRST_STEP_DONE`` and ``steady_state``; the global rank 0
    alone writes checkpoints.  Over a mesh the result's ``ranks`` are
    the pod's own ranks' launches and peaks, each with its global
    ``rank``."""
    device = resolve_device(args.device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
    reporter = mesh is None or mesh.local_rank == 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    resnet = args.model in RESNET_MODELS
    if resnet:
        state, next_batch = build_resnet_trainer(args, mesh)

        def step(state, batch):
            return resnet_step(state, *batch)
    elif args.model == "moe":
        state, next_batch = build_moe_trainer(args, mesh)

        def step(state, batch):
            return moe_step(state, batch)[0]
    elif args.model == "pp":
        state, next_batch = build_pp_trainer(args, mesh)
        step = pipeline_lm_step
    else:
        state, next_batch = build_trainer(args, mesh)
        step = lm_step
    # the pipeline declines checkpoints, as in JAX (run_pp warns)
    ckpt = (CheckpointHooks(args, state, writer)
            if args.ckpt_dir and args.model != "pp" else None)
    # a resumed run reads the batches the uninterrupted run would have
    # read from here on (the JAX worker restarts its stream instead)
    for _ in range(state.step):
        next_batch()
    dp = 1 if mesh is None else mesh.axis_size("data")
    # a pipeline step takes --microbatches windows of --batch-per-chip
    batch = max(args.batch_per_chip, 1) * (
        max(args.microbatches, 1) if args.model == "pp" else dp)
    # images a step, or tokens
    items, unit = ((batch, "images_per_sec") if resnet
                   else (batch * args.seq, "tokens_per_sec"))
    counts0 = read_counters()
    delta0 = flash_backward_delta.launches
    traffic0 = dict(CP_TRAFFIC)

    losses = [step(state, next_batch())]
    first_loss = float(losses[0])  # forces the step to completion
    first_s = time.monotonic() - t0
    if reporter:
        print(f"FIRST_STEP_DONE seconds={first_s:.2f} loss={first_loss:.4f}",
              flush=True)
    t1 = time.monotonic()
    save_s = 0.0
    for _ in range(args.steps - 1):
        losses.append(step(state, next_batch()))
        if ckpt is not None:
            save_s += ckpt.maybe_save(state, state.step, args.ckpt_every)
    losses = torch.stack(losses).tolist()  # forces the whole chain
    # the saves are not training: they are left out of the rate
    dt = time.monotonic() - t1 - save_s
    rate = items * (args.steps - 1) / dt if args.steps > 1 else None
    if rate is not None and reporter:
        print(f"steady_state {unit}={rate:.1f} loss={losses[-1]:.4f}",
              flush=True)
    launches = {k: n - counts0[k] for k, n in read_counters().items()}
    launches["DELTA"] = flash_backward_delta.launches - delta0
    if ckpt is not None:
        ckpt.finish(state)
    mine = {
        "launches": launches,
        "k3_launches": launches["K3"],
        "k4_launches": launches["K4"],
        "k5_launches": launches["K5"],
        "delta_launches": launches["DELTA"],
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "device": str(device),
        "cp_traffic": {k: v - traffic0[k] for k, v in CP_TRAFFIC.items()},
        "rank": 0 if mesh is None else mesh.rank,
    }
    r = dict(mine, first_step_s=first_s, steady_s=dt, losses=losses,
             steps=args.steps, step=state.step, **{unit: rate})
    if resnet:
        r.update(images_per_step=batch, model=args.model)
    else:
        r.update(layers=args.layers, tokens_per_step=batch * args.seq)
    if ckpt is not None:
        r["checkpoint"] = ckpt.report()
    if mesh is not None:
        r["mesh"] = dict(mesh.shape)
        first = mesh.rank - mesh.local_rank
        r["ranks"] = gather_objects(mine, mesh)[
            first:first + mesh.local_size]
    return r


def _train_rank(rank: int, args: argparse.Namespace, axes: dict,
                gang: GangTable) -> None:
    """Rank ``rank`` of the training mesh, started by its pod's first
    rank: the same steps as every rank, in lock-step through the
    collectives."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = join_training_mesh(args, axes, rank, gang)
    try:
        _train(args, mesh, time.monotonic())
    finally:
        close_mesh(mesh)


def join_training_mesh(args: argparse.Namespace, axes: dict, rank: int,
                       gang: GangTable, store=None):
    """Rank ``rank``'s training mesh of ``axes`` over the pods of
    ``gang`` (one on a host alone, :func:`_train_over_mesh`): the rank
    meets the others at the gang's store (``store``, the one its pod's
    first rank opened, else a new client), on its local device
    (``cuda:i`` for its local rank i), over the backend every rank's
    published device decides (:func:`gang_backend`: NCCL between cards,
    gloo on the CPU or on a shared card)."""
    n = int(np.prod(list(axes.values())))
    local = n // gang.num_processes
    devices = tp_devices(args, local)
    device = resolve_device(devices[rank % local])
    if store is None:
        store = open_gang_store(gang, is_master=False)
    backend = gang_backend(store, gang, rank, n, device)
    return device_mesh(axes, rank, backend=backend, device=device,
                       store=store,
                       devices=tuple(devices) * gang.num_processes,
                       local_size=local)


def run_lm(args: argparse.Namespace,
           t0: Optional[float] = None) -> Dict[str, object]:
    """Train ``--steps`` steps and return what was measured (rank 0's,
    with every rank's launches and peak memory under ``ranks`` over a
    mesh).  Prints ``FIRST_STEP_DONE`` once the first step's loss is read
    back (timed from ``t0``, the caller's start) and ``steady_state``
    after the other steps, which are timed with one readback at their
    end.  Over several devices (:func:`training_mesh`) it starts ranks
    1..n-1 and is rank 0 itself; ``--model lm-cp`` always runs over its
    mesh, of one rank at one device."""
    t0 = time.monotonic() if t0 is None else t0
    dp, width = training_mesh(args)
    cp = args.model == "lm-cp"
    if dp * width == 1 and not cp:
        return _train(args, None, t0)
    return _train_over_mesh(
        args, {"data": dp, "seq" if cp else "model": width}, t0)


def run_resnet(args: argparse.Namespace,
               t0: Optional[float] = None) -> Dict[str, object]:
    """Train the ``--model`` ResNet ``--steps`` steps and return what was
    measured, as :func:`run_lm`: at one device in this process; over n
    devices (:func:`training_devices`) on a ``{"data": n}`` mesh whose
    ranks 1..n-1 it starts, being rank 0 itself."""
    t0 = time.monotonic() if t0 is None else t0
    n = training_devices(args)
    if n == 1:
        return _train(args, None, t0)
    return _train_over_mesh(args, {"data": n}, t0)


def run_moe(args: argparse.Namespace,
            t0: Optional[float] = None) -> Dict[str, object]:
    """Train ``--model moe`` ``--steps`` steps and return what was
    measured, as :func:`run_lm`: at one device in this process, else
    over :func:`moe_mesh`'s mesh, whose ranks 1..n-1 it starts."""
    t0 = time.monotonic() if t0 is None else t0
    axes = moe_mesh(args)
    if int(np.prod(list(axes.values()))) == 1:
        return _train(args, None, t0)
    return _train_over_mesh(args, axes, t0)


def run_pp(args: argparse.Namespace,
           t0: Optional[float] = None) -> Dict[str, object]:
    """Train ``--model pp`` ``--steps`` steps and return what was
    measured, as :func:`run_lm`: at one stage in this process, else over
    a ``{"pipe": stages}`` mesh (:func:`pp_stages`) whose ranks 1..n-1
    it starts.  ``--ckpt-dir`` is ignored with a warning, as in JAX."""
    t0 = time.monotonic() if t0 is None else t0
    if args.ckpt_dir:
        log.warning("--ckpt-dir is not supported for --model pp; ignoring")
    stages = pp_stages(args)
    if stages == 1:
        return _train(args, None, t0)
    return _train_over_mesh(args, {"pipe": stages}, t0)


def _train_over_mesh(args: argparse.Namespace, axes: dict,
                     t0: float) -> Dict[str, object]:
    """This pod's half of a training mesh of ``axes``: in a gang of P
    pods of L ranks (:func:`pod_gang`; a pod alone is a gang of one on
    :func:`open_host_gang`'s store) rank pL, starting ranks
    pL+1..pL+L-1 once every pod has said it holds L.  Prints
    ``TRAINING_MESH``, trains, joins its ranks (raising if one
    failed)."""
    cp = args.model == "lm-cp"
    size = int(np.prod(list(axes.values())))
    gang = pod_gang()
    if gang is None:
        store, gang = open_host_gang()
    else:
        store = open_gang_store(gang, is_master=gang.process_id == 0)
    local = size // gang.num_processes
    first = gang.process_id * local
    check_local_counts(store, gang, local)
    procs = start_ranks(_train_rank, range(first + 1, first + local), args,
                        axes, gang)
    # a MoE mesh without tensor parallelism still names its model width
    shown = (dict(axes, model=1) if args.model == "moe"
             and "model" not in axes else axes)
    try:
        mesh = join_training_mesh(args, axes, first, gang, store)
        print("TRAINING_MESH " + " ".join(f"{k}={v}" for k, v in shown.items())
              + ("" if gang.num_processes == 1 else
                 f" process={gang.process_id}/{gang.num_processes}")
              + " devices=" + ",".join(mesh.devices)
              + f" backend={mesh.backend}"
              + (f" attn_impl={cp_attn_impl(args)}" if cp else ""),
              flush=True)
        try:
            r = _train(args, mesh, t0)
        finally:
            close_mesh(mesh)
    finally:
        codes = join_ranks(procs)
    if any(codes):
        raise RuntimeError(f"training ranks {first + 1}..{first + local - 1}"
                           f" exited with {codes}")
    return r


def main(argv: Optional[List[str]] = None) -> int:
    t0 = time.monotonic()
    args = build_parser().parse_args(argv)
    if args.model not in TRAINING_MODELS and args.cpu_ranks != 1:
        raise SystemExit("--cpu-ranks stands in for the training mesh's "
                         "devices: --model " + "|".join(TRAINING_MODELS)
                         + " --device cpu only")
    if args.model in RESNET_MODELS:
        report_resnet(run_resnet(args, t0))
        return 0
    if args.model in ("lm", "lm-cp"):
        report_lm(run_lm(args, t0))
        return 0
    if args.model == "moe":
        report_lm(run_moe(args, t0))
        return 0
    if args.model == "pp":
        report_lm(run_pp(args, t0))
        return 0
    if args.serve_http is not None:
        return serve_http(args, t0)
    if args.serve:
        run_decode(args, report=lambda r: report_decode(args, r))
    else:
        report_decode(args, run_decode(args))
    return 0


def report_lm(r: Dict[str, object]) -> None:
    """The launch and peak-memory lines of a training run: rank 0's,
    or over a mesh each of the pod's ranks', marked ``rank=r`` (its
    global rank)."""
    ranks = r.get("ranks") or [r]
    for mine in ranks:
        tag = f" rank={mine['rank']}" if "ranks" in r else ""
        for name, fn, key in (("K3", flash_forward, "k3_launches"),
                              ("K4", flash_backward_dkdv, "k4_launches"),
                              ("K5", flash_backward_dq, "k5_launches"),
                              ("DELTA", flash_backward_delta,
                               "delta_launches")):
            print(f"{name}_LAUNCHES {fn.__name__}={mine[key]} "
                  f"steps={r['steps']} layers={r['layers']} "
                  f"device={mine['device']}{tag}", flush=True)
        peak = mine["peak_bytes"]
        print("PEAK_MEM_GIB "
              + (f"{peak / 2**30:.2f}" if peak is not None else "not measured")
              + f" device={mine['device']}{tag}", flush=True)
        if "seq" in r.get("mesh", {}):
            print("CP_BYTES " + " ".join(
                f"{k}={v}" for k, v in mine["cp_traffic"].items())
                + f" steps={r['steps']}{tag}", flush=True)
        if "pipe" in r.get("mesh", {}):
            sent = mine["cp_traffic"]
            print(f"PP_BYTES hops={sent['ring_shift']} "
                  f"host_staged={sent['host_staged']} steps={r['steps']}"
                  f"{tag}", flush=True)


def report_resnet(r: Dict[str, object]) -> None:
    """The launch and peak-memory lines of a ResNet run: every kernel of
    the port by ID (none is on this path, so every count is 0), then the
    peak memory; over a mesh each of the pod's ranks', marked ``rank=r``
    (its global rank)."""
    ranks = r.get("ranks") or [r]
    for mine in ranks:
        tag = f" rank={mine['rank']}" if "ranks" in r else ""
        print("KERNEL_LAUNCHES "
              + " ".join(f"{k}={v}" for k, v in mine["launches"].items())
              + f" model={r['model']} device={mine['device']}{tag}",
              flush=True)
        peak = mine["peak_bytes"]
        print("PEAK_MEM_GIB "
              + (f"{peak / 2**30:.2f}" if peak is not None else "not measured")
              + f" device={mine['device']}{tag}", flush=True)


def report_decode(args: argparse.Namespace, r: Dict[str, object]) -> None:
    print(f"FIRST_DECODE_DONE seconds={r['first_decode_s']:.2f}", flush=True)
    if args.serving == "static":
        print(f"DECODE_DONE tokens_per_sec={r['tokens_per_sec']:.1f} "
              f"ms_per_call={r['ms_per_call']:.1f}", flush=True)
    else:
        print(
            f"DECODE_DONE tokens_per_sec={r['tokens_per_sec']:.1f} "
            f"serving={args.serving} requests={r['requests']} "
            f"steps={r['steps']} admits={r['admits']}",
            flush=True,
        )
    if args.serving != "paged":
        # the dense modes run no kernel of the port: every count is 0
        peak = r.get("peak_bytes")
        print("KERNEL_LAUNCHES "
              + " ".join(f"{k}={v}" for k, v in r["launches"].items())
              + f" serving={args.serving} device={r['device']}", flush=True)
        if peak is not None:
            print(f"PEAK_MEM_GIB {peak / 2**30:.2f} device={r['device']}",
                  flush=True)
        return
    print(
        f"K1_LAUNCHES paged_decode_attention={r['k1_launches']} "
        f"decode_steps={r['decode_steps_total']} layers={r['layers']} "
        f"device={r['device']} "
        f"K1Q_LAUNCHES paged_decode_attention_int8={r['k1q_launches']} "
        f"kv_dtype={r['kv_dtype']}",
        flush=True,
    )
    if args.speculate:
        print(
            f"SPEC_DONE spec_steps={r['spec_steps']} "
            f"spec_tokens={r['spec_tokens']} "
            f"draft_wraps={r['draft_wraps']} k={args.spec_k} "
            f"K2_LAUNCHES paged_chunk_attention={r['k2_launches']} "
            f"spec_steps_total={r['spec_steps_total']} "
            f"K2Q_LAUNCHES paged_chunk_attention_int8={r['k2q_launches']}",
            flush=True,
        )


if __name__ == "__main__":
    raise SystemExit(main())
