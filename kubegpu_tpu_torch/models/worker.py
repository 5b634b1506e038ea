"""Worker of the port: ``--model decode --serving paged`` (serving) and
``--model lm`` (training).

The port of ``kubegpu_tpu/models/worker.py``'s paged decode mode and its
single-device LM training.  In decode mode it builds the LM at the
given widths with fresh weights drawn from a fixed seed, serves one
warm-up wave of requests and one timed wave through
:class:`PagedContinuousBatcher`, and prints the JAX worker's
``FIRST_DECODE_DONE`` / ``DECODE_DONE`` lines plus the launch counts of
the paged attention kernels (K1, K2).  A wave is the JAX worker's: ``2 x
--batch-per-chip`` prompts of random length in ``[1, --prompt-len]``
from ``np.random.RandomState(0)``, budgets cycling ``1/4 .. 1 x
--steps``.  ``--speculate`` serves greedy speculative decoding through
the same pool: a fresh draft of ``--draft-layers`` layers proposes
``--spec-k`` tokens a step and one verify window (K2) scores them; the
streams are the non-speculative ones, token for token, at fp32.
``--kv-dtype int8`` stores the pool (and the draft ring) as int8 pages
with per-page, per-head scales, read by K1q/K2q; ``--int8`` serves
weight-only int8 weights (printing ``SERVING_INT8``);
``--decode-page-cache`` lets retirement seal decode-produced pages into
the prefix chain.  ``--sample-temperature T`` samples instead of taking
the argmax, as the JAX worker does: request i of a wave pins seed
``--sample-seed + i`` (the same streams on every rerun and replica),
``--sample-top-k`` truncates to the k most likely tokens, and with
``--speculate`` the verify runs rejection-sampled speculation.
``--serve`` replays waves forever after the timed one, printing
``SERVING tokens_per_sec=`` per wave.

    python -m kubegpu_tpu_torch.models.worker --model decode --serving paged \\
        --vocab 32768 --hidden 4096 --heads 32 --layers 4 \\
        --prompt-len 128 --batch-per-chip 8 --steps 64 [--speculate] \\
        [--kv-dtype int8] [--int8] [--decode-page-cache quantized] \\
        [--sample-temperature 0.8 [--sample-top-k 50] [--sample-seed 0]]

``--serve-http PORT`` serves the batcher as a replica HTTP endpoint
instead (``gateway/dataplane.py``, the JAX replica's wire schema): it
builds the batcher, warms every kernel and path it runs (the decode
step or, with ``--speculate``, the draft scan and the verify; prefill,
page scatter and gather), then prints ``REPLICA_HTTP_SERVING port=N
serving=paged role=R tls=0|1 seconds=S`` and serves ``POST /v1/submit``
(SSE), ``POST /v1/cancel``, the migration verbs ``POST /v1/export``,
``/v1/import`` and ``/v1/role``, ``GET /v1/state``, ``GET /healthz`` and
``GET /metrics`` until SIGTERM, when it prints ``REPLICA_HTTP_STOPPED``
and exits 0.  ``--role prefill|decode|flex`` is the replica's
disaggregation role (``prefill`` parks each sequence at its seal for the
gateway's handoff), ``--serve-http-fail-migration`` refuses every import
(a chaos knob), ``--serve-http-tls-cert/-key`` serve HTTPS,
``--serve-http-auth-token-file`` gates ``/v1/*`` behind a bearer token,
``--serve-http-step-delay`` slows the loop (a test knob).

    python -m kubegpu_tpu_torch.models.worker --model decode --serving paged \\
        --serve-http 0 [--role prefill] [--speculate] [--kv-dtype int8]

``--model lm`` trains ``TransformerLM`` (bf16 compute over float32
weights drawn fresh from seed 0, nesterov SGD) on the JAX worker's
synthetic token stream, ``--batch-per-chip`` windows of ``--seq + 1``
tokens a step.  It prints the JAX worker's ``FIRST_STEP_DONE`` and
``steady_state tokens_per_sec=`` lines, then the launch counts of the
flash-attention kernels (K3 forward, K4 and K5 backward; with ``--remat``
K3 runs twice a layer) and the peak device memory.  ``--attn-impl flash``
(the default) runs those kernels, ``einsum`` the model-dtype einsum
attention.  One device only: ``--tp`` above 1 waits for the tensor-
parallel slice, ``--attn-impl ring|ulysses`` for the long-context one.

    python -m kubegpu_tpu_torch.models.worker --model lm --vocab 32768 \\
        --hidden 4096 --heads 32 --layers 4 --seq 1024 \\
        --batch-per-chip 16 --steps 5

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (the kernels are then never launched).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubegpu_tpu_torch.models.data import (
    device_pool_batches,
    prefetch_to_device,
    synthetic_token_batches,
)
from kubegpu_tpu_torch.models.decoding import quantize_params_int8
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import bf16_cast, init_params, resolve_device
from kubegpu_tpu_torch.models.serving import (
    DECODE_PAGE_CACHE_POLICIES,
    KV_DTYPES,
    resolve_kv_dtype,
)
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
from kubegpu_tpu_torch.utils.metrics import Metrics

WEIGHT_SEED = 0
# the draft's weights come from their own seed (the JAX worker's draft
# init uses PRNGKey(7))
DRAFT_SEED = 7


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["decode", "lm"], default="decode",
                    help="decode = paged serving; lm = LM training at one "
                    "device")
    ap.add_argument("--serving", choices=["paged"], default="paged",
                    help="paged = continuous batching over a shared KV "
                    "page pool (the only serving mode ported so far)")
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
                    help="draft proposals per verify window")
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
                    help="tensor-parallel size: 0 (all devices) or 1; the "
                    "port runs on one device until the tensor-parallel slice")
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
            f"--tp {args.tp}: tensor parallelism arrives with the tensor-"
            "parallel slice of the port; it runs on one device (--tp 0 or 1)")


def wave_requests(rng: np.random.RandomState, n_req: int, vocab: int,
                  prompt_len: int) -> List[np.ndarray]:
    """One wave's prompts, drawn exactly as the JAX worker draws them."""
    return [
        rng.randint(0, vocab, size=rng.randint(1, prompt_len + 1),
                    dtype=np.int32)
        for _ in range(n_req)
    ]


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
    d_hidden = args.draft_hidden or max(args.hidden // 4, 128)
    d_heads = max(d_hidden // 128, 1)
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


def build_batcher(args: argparse.Namespace) -> PagedContinuousBatcher:
    """The worker's batcher: fresh weights from ``WEIGHT_SEED`` at the
    given widths (bf16 unless ``--serve-fp32``), a pool sized for
    ``--batch-per-chip`` sequences of ``--prompt-len + --steps`` rows
    (plus ``--spec-k`` rows of verify headroom when speculating)."""
    check_one_device(args)
    device = resolve_device(args.device)
    max_seq = args.seq + 1
    if args.prompt_len + args.steps > max_seq:
        raise SystemExit(
            f"--prompt-len {args.prompt_len} + --steps {args.steps} exceeds "
            f"the cache size --seq+1 = {max_seq}"
        )
    if args.page_size is not None:
        if args.page_size < 1 or args.prompt_len % args.page_size:
            raise SystemExit(
                f"--page-size {args.page_size} must be positive and divide "
                f"--prompt-len {args.prompt_len} (whole-page admit scatter)"
            )
        page = args.page_size
    else:
        page = 128 if args.prompt_len % 128 == 0 else args.prompt_len
    cfg = dict(vocab_size=args.vocab, num_layers=args.layers,
               num_heads=args.heads, hidden=args.hidden, max_seq=max_seq)
    dtype = torch.float32 if args.serve_fp32 else torch.bfloat16
    try:
        # a contradictory pair (e.g. --kv-dtype bf16 with --serve-fp32)
        # dies here, like the other geometry checks
        resolve_kv_dtype(args.kv_dtype, dtype)
    except ValueError as e:
        raise SystemExit(str(e))
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    params = init_params(cfg, gen, torch.float32, device)
    if not args.serve_fp32:
        params = bf16_cast(params)
    if args.int8:
        params = quantize_params_int8(params)
        print("SERVING_INT8 weight-only per-output-channel", flush=True)
    spec_kw = {}
    k_extra = 0
    if args.speculate:
        dparams, d_heads, d_hidden = draft_for(args, max_seq, device)
        spec_kw = dict(draft_params=dparams, speculate_k=args.spec_k,
                       draft_num_layers=args.draft_layers,
                       draft_num_heads=d_heads, draft_hidden=d_hidden)
        k_extra = args.spec_k  # per-sequence page-reservation headroom
    slots = args.batch_per_chip
    pool = slots * -(-(args.prompt_len + args.steps + k_extra) // page) + 1
    return PagedContinuousBatcher(
        params, **cfg, slots=slots, prompt_pad=args.prompt_len,
        page_size=page, pool_pages=pool, dtype=dtype, device=device,
        quant=args.int8, kv_dtype=args.kv_dtype,
        decode_page_cache=args.decode_page_cache,
        # sampled traffic keeps speculation: the verify rejection-samples
        sampling=args.sample_temperature > 0, top_k=args.sample_top_k,
        **spec_kw,
    )


def sampled_wave_kw(args: argparse.Namespace, n_req: int) -> dict:
    """The ``run`` arguments of a sampled wave, as the JAX worker's: every
    request at ``--sample-temperature``, request i pinning seed
    ``--sample-seed + i``; empty when the worker decodes greedily."""
    if args.sample_temperature <= 0:
        return {}
    return dict(temperatures=[args.sample_temperature] * n_req,
                seeds=[args.sample_seed + i for i in range(n_req)])


def warm_batcher(cb: PagedContinuousBatcher,
                 temperature: float = 0.0) -> None:
    """Pay every first-use cost before traffic: build the kernel
    libraries, then serve two full-length prompts that share all their
    full pages, one after the other, so the station prefill, the page
    scatter, the prefix gather (where the prompt spans more than a page
    past the hit), the decode step (K1) or the draft scan and verify
    (K2), and retirement sealing all run once; the second samples at
    ``temperature`` when it is above 0.  The batcher's stats and step
    ledger are reset after, so they count served traffic only."""
    if cb.device.type == "cuda":
        _build.build()
    prompt = (np.arange(cb.prompt_pad, dtype=np.int32) * 7 + 1) % (
        cb.model.vocab_size)
    budget = max(1, min(2, cb.max_seq - cb.prompt_pad
                        - (cb.speculate_k or 0)))
    for seq, temp in ((0, 0.0), (1, temperature)):
        cb.submit(seq, prompt, budget, temp, seed=0 if temp > 0 else None)
        while cb.has_work():
            cb.serve_step()
    if cb.device.type == "cuda":
        torch.cuda.synchronize(cb.device)
    cb._reset_stats()
    cb._ledger.clear()


def run_decode(args: argparse.Namespace,
               report=None) -> Dict[str, object]:
    """Build the batcher, serve a warm-up wave and a timed wave, and
    return what was measured (the CLI prints it).  With ``--serve`` it
    hands that to ``report`` and then replays waves forever, printing
    ``SERVING tokens_per_sec=`` after each."""
    t0 = time.monotonic()
    cb = build_batcher(args)
    device = cb.device
    slots = args.batch_per_chip
    rng = np.random.RandomState(0)
    n_req = 2 * slots
    budgets = [max(args.steps * (1 + i % 4) // 4, 1) for i in range(n_req)]
    run_kw = sampled_wave_kw(args, n_req)
    counters = ((paged_decode_attention, "launches"),
                (paged_decode_attention, "int8_launches"),
                (paged_chunk_attention, "launches"),
                (paged_chunk_attention, "int8_launches"))
    launches0 = [getattr(fn, attr) for fn, attr in counters]

    def wave():
        prompts = wave_requests(rng, n_req, args.vocab, args.prompt_len)
        tw = time.monotonic()
        out = cb.run(prompts, budgets, **run_kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.monotonic() - tw

    out, _ = wave()  # warm-up: first-use costs (kernel build, allocator)
    steps = cb.stats["steps"]
    spec_steps = cb.stats["spec_steps"]
    first_s = time.monotonic() - t0
    out, dt = wave()
    steps += cb.stats["steps"]
    spec_steps += cb.stats["spec_steps"]
    ttft = sorted(cb.first_token_s.values())
    total = sum(len(v) for v in out.values())
    k1, k1q, k2, k2q = (getattr(fn, attr) - n
                        for (fn, attr), n in zip(counters, launches0))
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
        "k1_launches": k1,
        "k1q_launches": k1q,
        "k2_launches": k2,
        "k2q_launches": k2q,
        "kv_dtype": cb.kv_dtype,
        "pool_bytes": cb.pool_kv_bytes + cb.pool_scale_bytes,
        "spec_steps": cb.stats["spec_steps"],
        "spec_tokens": cb.stats["spec_tokens"],
        "draft_wraps": cb.stats["draft_wraps"],
        "spec_steps_total": spec_steps,
        "ttft_mean_s": float(np.mean(ttft)) if ttft else None,
        "ttft_max_s": ttft[-1] if ttft else None,
        "outputs": out,
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


def serve_http(args: argparse.Namespace, t0: float) -> int:
    """``--serve-http``: expose the batcher as a replica HTTP endpoint
    (``gateway/dataplane.py``) until SIGTERM.  The device is checked
    (``build_batcher`` raises without a card unless ``--device cpu``)
    and every kernel warmed before the port is bound and advertised."""
    import signal
    import threading

    from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer

    if bool(args.serve_http_tls_cert) != bool(args.serve_http_tls_key):
        raise SystemExit(
            "--serve-http-tls-cert and --serve-http-tls-key must be given "
            "together")
    auth_token = None
    if args.serve_http_auth_token_file:
        with open(args.serve_http_auth_token_file) as f:
            auth_token = f.read().strip()
    cb = build_batcher(args)
    warm_batcher(cb, args.sample_temperature)
    metrics = Metrics()
    cb.attach_metrics(metrics)
    counters = {"K1": (paged_decode_attention, "launches"),
                "K1q": (paged_decode_attention, "int8_launches"),
                "K2": (paged_chunk_attention, "launches"),
                "K2q": (paged_chunk_attention, "int8_launches")}
    launches0 = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
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
    launches = " ".join(f"{k}_LAUNCHES={getattr(fn, a) - launches0[k]}"
                        for k, (fn, a) in counters.items())
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
    print(
        f"DECODE_DONE tokens_per_sec={r['tokens_per_sec']:.1f} "
        f"serving={args.serving} requests={r['requests']} "
        f"steps={r['steps']} admits={r['admits']}",
        flush=True,
    )
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
