"""Worker of the port: ``--model decode`` (serving) and ``--model lm``
(training).

The port of ``kubegpu_tpu/models/worker.py``'s decode modes and its
single-device LM training.  In decode mode it builds the LM at the given
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
``--serve-http`` refuses ``static`` and ``speculative``.  ``--ckpt-dir``
and ``--draft-ckpt-dir`` wait for the
checkpoint slice: every mode serves fresh weights, as the JAX worker
does when it finds no checkpoint.

``--model lm`` trains ``TransformerLM`` (bf16 compute over float32
weights drawn fresh from seed 0, nesterov SGD) on the JAX worker's
synthetic token stream, ``--batch-per-chip`` windows of ``--seq + 1``
tokens a step.  It prints the JAX worker's ``FIRST_STEP_DONE`` and
``steady_state tokens_per_sec=`` lines, then the launch counts of the
flash-attention kernels (K3 forward, K4 and K5 backward; with ``--remat``
K3 runs twice a layer) and the peak device memory.  ``--attn-impl flash``
(the default) runs those kernels, ``einsum`` the model-dtype einsum
attention.  One device only: ``--tp`` above 1 waits for the data x
tensor-parallel training slice, ``--attn-impl ring|ulysses`` for the
long-context one.

    python -m kubegpu_tpu_torch.models.worker --model lm --vocab 32768 \\
        --hidden 4096 --heads 32 --layers 4 --seq 1024 \\
        --batch-per-chip 16 --steps 5

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (the kernels are then never launched).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubegpu_tpu_torch.models.data import (
    device_pool_batches,
    prefetch_to_device,
    synthetic_token_batches,
)
from kubegpu_tpu_torch.models.decoding import (
    greedy_generate,
    quantize_params_int8,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import bf16_cast, init_params, resolve_device
from kubegpu_tpu_torch.models.serving import (
    DECODE_PAGE_CACHE_POLICIES,
    KV_DTYPES,
    ContinuousBatcher,
    resolve_kv_dtype,
)
from kubegpu_tpu_torch.models.spec_serving import SpeculativeContinuousBatcher
from kubegpu_tpu_torch.models.train import create_train_state, lm_step
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
    join_ranks,
    open_store,
    start_ranks,
)
from kubegpu_tpu_torch.parallel.mesh import close_mesh, device_mesh
from kubegpu_tpu_torch.utils.metrics import Metrics

WEIGHT_SEED = 0
# the draft's weights come from their own seed (the JAX worker's draft
# init uses PRNGKey(7))
DRAFT_SEED = 7


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["decode", "lm"], default="decode",
                    help="decode = serving; lm = LM training at one device")
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
                    help="decode: budget of the longest request; lm: "
                    "training steps")
    ap.add_argument("--batch-per-chip", type=int, default=32,
                    help="decode: slots (a wave holds twice as many "
                    "requests); lm: token windows a step")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--layers", type=int, default=4)
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
                    "kernels, einsum = model-dtype einsum attention; ring "
                    "and ulysses wait for the long-context slice")
    ap.add_argument("--remat", action="store_true",
                    help="lm: recompute each block in the backward")
    ap.add_argument("--tp", type=int, default=0,
                    help="decode --serving paged: tensor-parallel ranks (0 "
                    "or 1: one device; N: cuda:0..N-1 over NCCL, or N CPU "
                    "processes over gloo with --device cpu); lm: 0 or 1")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "stream", "resident"],
                    help="lm: synthetic = a pool of --data-pool distinct "
                    "batches on the device; stream = pinned, prefetched "
                    "host-to-device copies; resident = one constant batch")
    ap.add_argument("--data-pool", type=int, default=8,
                    help="lm --data synthetic: distinct batches to cycle")
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
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def check_one_device(args: argparse.Namespace) -> None:
    if args.tp not in (0, 1):
        raise SystemExit(
            f"--tp {args.tp}: tensor-parallel training arrives with the "
            "data x tensor-parallel training slice of the port; --model lm "
            "runs on one device (--tp 0 or 1)")


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


def draft_for(args: argparse.Namespace, max_seq: int, device):
    """The draft of ``--speculate``: fresh weights from ``DRAFT_SEED``
    (bf16 unless ``--serve-fp32``), ``--draft-layers`` deep and
    ``--draft-hidden`` wide with heads of 128, as the JAX worker sizes
    it.  Also enforces the speculation headroom rule: a verify window
    writes rows ``[pos, pos + k]``, so the cache needs k rows past
    prompt plus budget.  Returns ``(params, heads, hidden)``."""
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


def tp_devices(args: argparse.Namespace) -> List[str]:
    """Each rank's device: ``cuda:r``, or the CPU for every rank."""
    if args.device == "cpu":
        return ["cpu"] * args.tp
    return [f"cuda:{r}" for r in range(args.tp)]


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
    """The served weights: fresh from ``WEIGHT_SEED`` at the given widths,
    bf16 unless ``--serve-fp32``, int8 under ``--int8`` (quantized whole,
    before any tensor-parallel sharding).  ``announce`` prints the int8
    line.  Returns ``(params, model config, dtype)``."""
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               num_heads=args.heads, hidden=args.hidden, max_seq=args.seq + 1)
    dtype = torch.float32 if args.serve_fp32 else torch.bfloat16
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
    if args.serving == "speculative":
        # the draft is fresh weights: greedy output equals the dense
        # batcher's for any draft, only the verify count moves
        dparams, d_heads, d_hidden = draft_for(args, max_seq, device)
        return SpeculativeContinuousBatcher(
            params, dparams, **common, k=args.spec_k,
            draft_num_layers=args.draft_layers, draft_num_heads=d_heads,
            draft_hidden=d_hidden, **sample_kw)
    spec_kw = {}
    k_extra = 0
    if args.speculate:
        dparams, d_heads, d_hidden = draft_for(args, max_seq, device)
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


def make_batches(args: argparse.Namespace, source, device):
    """The ``--data`` modes, as the JAX worker's ``_make_batches``:
    returns ``(batches, first)`` with ``batches`` None in resident mode,
    where ``first`` is the constant batch.  The JAX worker sizes its
    init with the first batch of a pool or stream; taking it here too
    keeps step i on the JAX worker's batch i."""
    if args.data == "synthetic":
        batches = device_pool_batches(source, device,
                                      pool=max(args.data_pool, 1))
        return batches, next(batches)
    if args.data == "stream":
        batches = prefetch_to_device(source, device, depth=2)
        return batches, next(batches)
    return None, torch.from_numpy(next(source)).to(device)


def build_trainer(args: argparse.Namespace):
    """The worker's training state and batch source at the given widths:
    fresh float32 weights from ``WEIGHT_SEED``, bf16 compute, nesterov
    SGD, the ``--data`` mode's batches.  Returns ``(state,
    next_batch)``."""
    check_one_device(args)
    if args.attn_impl in ("ring", "ulysses"):
        raise SystemExit(
            f"--attn-impl {args.attn_impl}: context-parallel attention "
            "arrives with the long-context slice of the port; use flash or "
            "einsum")
    if args.hidden % args.heads:
        raise SystemExit(f"--hidden {args.hidden} not divisible by --heads "
                         f"{args.heads}")
    device = resolve_device(args.device)
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               hidden=args.hidden, max_seq=args.seq + 1)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    model = TransformerLM(**cfg, num_heads=args.heads, dtype=torch.bfloat16,
                          sequence_parallel=True, attn_impl=args.attn_impl,
                          remat=args.remat)
    state = create_train_state(model,
                               init_params(cfg, gen, torch.float32, device))
    source = synthetic_token_batches(max(args.batch_per_chip, 1),
                                     args.seq + 1, args.vocab)
    batches, const = make_batches(args, source, device)

    def next_batch():
        return const if batches is None else next(batches)

    return state, next_batch


def run_lm(args: argparse.Namespace,
           t0: Optional[float] = None) -> Dict[str, object]:
    """Train ``--steps`` steps and return what was measured.  Prints
    ``FIRST_STEP_DONE`` once the first step's loss is read back (timed
    from ``t0``, the caller's start) and ``steady_state`` after the
    other steps, which are timed with one readback at their end."""
    t0 = time.monotonic() if t0 is None else t0
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, next_batch = build_trainer(args)
    batch = max(args.batch_per_chip, 1)
    kernels = (flash_forward, flash_backward_dkdv, flash_backward_dq,
               flash_backward_delta)
    launches0 = [fn.launches for fn in kernels]

    losses = [lm_step(state, next_batch())]
    first_loss = float(losses[0])  # forces the step to completion
    first_s = time.monotonic() - t0
    print(f"FIRST_STEP_DONE seconds={first_s:.2f} loss={first_loss:.4f}",
          flush=True)
    t1 = time.monotonic()
    for _ in range(args.steps - 1):
        losses.append(lm_step(state, next_batch()))
    losses = torch.stack(losses).tolist()  # forces the whole chain
    dt = time.monotonic() - t1
    rate = batch * args.seq * (args.steps - 1) / dt if args.steps > 1 else None
    if rate is not None:
        print(f"steady_state tokens_per_sec={rate:.1f} loss={losses[-1]:.4f}",
              flush=True)
    k3, k4, k5, delta = (fn.launches - n for fn, n in zip(kernels, launches0))
    return {
        "first_step_s": first_s,
        "tokens_per_sec": rate,
        "steady_s": dt,
        "losses": losses,
        "steps": args.steps,
        "layers": args.layers,
        "tokens_per_step": batch * args.seq,
        "k3_launches": k3,
        "k4_launches": k4,
        "k5_launches": k5,
        "delta_launches": delta,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "device": str(device),
    }


def main(argv: Optional[List[str]] = None) -> int:
    t0 = time.monotonic()
    args = build_parser().parse_args(argv)
    if args.model == "lm":
        r = run_lm(args, t0)
        for name, fn, key in (("K3", flash_forward, "k3_launches"),
                              ("K4", flash_backward_dkdv, "k4_launches"),
                              ("K5", flash_backward_dq, "k5_launches"),
                              ("DELTA", flash_backward_delta,
                               "delta_launches")):
            print(f"{name}_LAUNCHES {fn.__name__}={r[key]} steps={r['steps']} "
                  f"layers={r['layers']} device={r['device']}", flush=True)
        peak = r["peak_bytes"]
        print("PEAK_MEM_GIB "
              + (f"{peak / 2**30:.2f}" if peak is not None else "not measured")
              + f" device={r['device']}", flush=True)
        return 0
    if args.serve_http is not None:
        return serve_http(args, t0)
    if args.serve:
        run_decode(args, report=lambda r: report_decode(args, r))
    else:
        report_decode(args, run_decode(args))
    return 0


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
