#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the port's serving paths from the sources in the
checkout, then runs seven phases; any failure exits non-zero:

1. device: the card's name and power limit, TF32 off;
2. K1 (paged decode attention, ``ops/csrc/paged_attention.cu``) against
   its plain PyTorch version at the serving path's shapes (8 slots, 32
   heads, head_dim 128, page 128, a shuffled table, ragged lengths
   including 0, 1, 127, 128 and a full table), in float32
   (rtol=atol=2e-5) and bfloat16 (rtol=2^-7, atol=1e-5: both compute in
   f32 and round once to bf16, so they may differ by one rounding step);
   its device time (launches captured in a CUDA graph), the plain
   version's time and its bandwidth bound;
3. K2 (paged multi-query attention, the speculative verify, same
   source) at the verify's shapes (8 slots, a 5-row window, 32 heads,
   head_dim 128, page 128, a shuffled 9-page table, lengths whose windows
   cross page boundaries and reach the full table) against its plain
   version and the dense oracle at the same tolerances; its row j must
   equal K1 at lengths + j bit for bit, and a 1-row window K1; its
   time, K1's at the same widest contexts, the plain time and the bound;
4. the serving path at the flagship's full width (vocab 32768, hidden
   4096, 4 layers, 32 heads, prompt 128, page 128, 8 slots, 16 requests
   per wave) in bfloat16 through the worker's entry point; K1 must have
   launched decode steps x layers times;
5. the same wave through the worker's ``--speculate --spec-k 4`` (a
   fresh 1-layer draft, hidden 1024): every budget met, K2 launched
   verify steps x layers times and K1 never;
6. card against CPU at float32 on a small model: first-step logits
   within rtol=atol=1e-4, and token streams identical wherever the CPU's
   top-2 logit margin exceeds 1e-3 (a closer call is printed as a
   near-tie);
7. speculation on the card at float32 on the same small model, k 2 and
   4, a hopeless and a perfect draft: pipelined and synchronous streams
   identical, streams equal to the card's plain streams under the
   near-tie rule, and the perfect draft needs fewer verify steps.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

F32_TOL = 2e-5
BF16_RTOL = 2 ** -7
BF16_ATOL = 1e-5
CARD_CPU_LOGIT_TOL = 1e-4
NEAR_TIE_MARGIN = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SPEC_K = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n: int, replays: int = 10) -> float:
    """Device time of one ``fn()``: n calls captured in one CUDA graph and
    replayed, so the host's cost per call stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, replays) / n


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} count={torch.cuda.device_count()} torch="
        f"{torch.__version__} cuda={torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from kubegpu_tpu_torch.ops import _build, paged_attention  # noqa: F401

    t0 = time.monotonic()
    paths = _build.build()
    log(f"build: {len(paths)} kernel libraries in "
        f"{time.monotonic() - t0:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def phase_k1() -> dict:
    import torch

    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
        reference_paged_attention,
    )

    dev = torch.device("cuda")
    b, h, hd, page = 8, 32, 128, 128
    n_pages = 9          # the flagship's table width: ceil(1025 / 128)
    pool = b * n_pages + 8
    lengths_l = [0, 1, 127, 128, 200, 513, 1000, n_pages * page]
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.stack([
        torch.randperm(pool, generator=g, device=dev)[:n_pages]
        for _ in range(b)
    ]).to(torch.int32)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    rec = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
        q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
        kp = (torch.randn((pool, h, page, hd), generator=g, device=dev)
              * 0.3).to(dtype)
        vp = (torch.randn((pool, h, page, hd), generator=g, device=dev)
              * 0.3).to(dtype)
        args = (q, kp, vp, table, lengths)
        out = paged_decode_attention(*args)
        plain = paged_decode_attention_plain(*args)
        dense = reference_paged_attention(*args)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        assert torch.isfinite(out.float()).all(), "K1 produced non-finite"
        assert (out[0] == 0).all(), "length-0 slot must give zeros"
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        # the worst element's share of its allowance (<= 1 passes)
        share = (diff / (atol + rtol * plain.float().abs())).max().item()
        err_dense = (out.float() - dense.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(out.float(), dense.float(), rtol=rtol,
                                   atol=atol)
        name = str(dtype).replace("torch.", "")
        log(f"K1 {name}: max|kernel - plain| = {err:.3e} ({share:.3f} of "
            f"rtol {rtol:.3g} atol {atol:.3g}), max|kernel - dense oracle| "
            f"= {err_dense:.3e}; mean |out| of the live slots "
            f"{out[1:].float().abs().mean().item():.3e}")
        itemsize = q.element_size()
        live_pages = sum(-(-n // page) for n in lengths_l)
        nbytes = (2 * sum(lengths_l) * h * hd * itemsize   # live K/V rows
                  + 2 * b * h * hd * itemsize              # q in, out
                  + 4 * (live_pages + b))                  # table, lengths
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = graph_ms(lambda: paged_decode_attention(*args), 50)
        call_ms = time_ms(lambda: paged_decode_attention(*args), 200)
        plain_ms = time_ms(lambda: paged_decode_attention_plain(*args), 20)
        log(f"K1 {name}: kernel {ms * 1e3:.2f} us (graph replay; "
            f"{call_ms * 1e3:.2f} us a call from Python), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes} B over "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) -> "
            f"{bound_ms / ms * 100:.1f}% of bound; no single PyTorch call "
            "computes paged attention, so library_ms is null")
        rec[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms,
                         bound_ms=bound_ms, bytes=nbytes)
    return rec


def phase_k2() -> dict:
    import torch

    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_chunk_attention_plain,
        paged_decode_attention,
        reference_paged_chunk_attention,
    )

    dev = torch.device("cuda")
    b, L, h, hd, page = 8, SPEC_K + 1, 32, 128, 128
    n_pages = 9          # the flagship's table width: ceil(1025 / 128)
    pool = b * n_pages + 8
    # windows crossing page boundaries (124..128), mid-table, and one
    # whose widest row reaches the full table (1148 + 4 = 1152 rows)
    lengths_l = [1, 124, 126, 127, 128, 513, 1000, n_pages * page - 4]
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.stack([
        torch.randperm(pool, generator=g, device=dev)[:n_pages]
        for _ in range(b)
    ]).to(torch.int32)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    widest = lengths + (L - 1)
    rec = {}
    for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL),
                              (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
        q = torch.randn((b, L, h, hd), generator=g, device=dev).to(dtype)
        kp = (torch.randn((pool, h, page, hd), generator=g, device=dev)
              * 0.3).to(dtype)
        vp = (torch.randn((pool, h, page, hd), generator=g, device=dev)
              * 0.3).to(dtype)
        args = (q, kp, vp, table, lengths)
        out = paged_chunk_attention(*args)
        plain = paged_chunk_attention_plain(*args)
        dense = reference_paged_chunk_attention(*args)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dtype
        assert torch.isfinite(out.float()).all(), "K2 produced non-finite"
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        share = (diff / (atol + rtol * plain.float().abs())).max().item()
        err_dense = (out.float() - dense.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(out.float(), dense.float(), rtol=rtol,
                                   atol=atol)
        # row j folds through K1's device routine: the same bits as K1 at
        # lengths + j, and a 1-row window is K1
        for j in range(L):
            single = paged_decode_attention(q[:, j].contiguous(), kp, vp,
                                            table, lengths + j)
            assert torch.equal(out[:, j], single), (
                f"K2 row {j} differs from K1 at lengths + {j}")
        one = paged_chunk_attention(q[:, :1].contiguous(), kp, vp, table,
                                    lengths)
        assert torch.equal(one[:, 0], paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, table, lengths)), (
            "a 1-row K2 window differs from K1")
        name = str(dtype).replace("torch.", "")
        log(f"K2 {name}: max|kernel - plain| = {err:.3e} ({share:.3f} of "
            f"rtol {rtol:.3g} atol {atol:.3g}), max|kernel - dense oracle| "
            f"= {err_dense:.3e}; rows 0..{L - 1} equal K1 at lengths + j "
            "bit for bit, and a 1-row window equals K1")
        itemsize = q.element_size()
        rows = [min(n + L - 1, n_pages * page) for n in lengths_l]
        live_pages = sum(-(-n // page) for n in rows)
        nbytes = (2 * sum(rows) * h * hd * itemsize      # widest rows' K/V
                  + 2 * b * L * h * hd * itemsize        # q in, out
                  + 4 * (live_pages + b))                # table, lengths
        # 2 flops for q.k and 2 for p.v per attended K/V row element
        flops = 4 * sum(min(n + j, n_pages * page)
                        for n in lengths_l for j in range(L)) * h * hd
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        ms = graph_ms(lambda: paged_chunk_attention(*args), 50)
        call_ms = time_ms(lambda: paged_chunk_attention(*args), 200)
        k1_args = (q[:, -1].contiguous(), kp, vp, table, widest)
        k1_ms = graph_ms(lambda: paged_decode_attention(*k1_args), 50)
        plain_ms = time_ms(lambda: paged_chunk_attention_plain(*args), 5)
        log(f"K2 {name}: kernel {ms * 1e3:.2f} us (graph replay; "
            f"{call_ms * 1e3:.2f} us a call from Python), K1 at the same "
            f"widest contexts {k1_ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by} ({nbytes} B over {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s = {bytes_ms * 1e3:.2f} us; {flops} flop over "
            f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s f32 = "
            f"{flops_ms * 1e3:.2f} us) -> {bound_ms / ms * 100:.1f}% of "
            "bound; no single PyTorch call computes paged multi-query "
            "attention, so library_ms is null")
        rec[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         k1_ms=k1_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, flops=flops)
    return rec


FLAGSHIP_ARGV = ["--model", "decode", "--serving", "paged", "--vocab",
                 "32768", "--hidden", "4096", "--layers", "4", "--heads",
                 "32", "--prompt-len", "128", "--page-size", "128",
                 "--batch-per-chip", "8", "--steps", "64"]


def check_wave(r: dict, args) -> None:
    """Every request of the wave came back with its full budget of
    in-vocabulary tokens."""
    assert r["requests"] >= 16
    budgets = [max(args.steps * (1 + i % 4) // 4, 1)
               for i in range(r["requests"])]
    out = r["outputs"]
    assert sorted(out) == list(range(r["requests"]))
    for i, toks in out.items():
        assert len(toks) == budgets[i], (i, len(toks), budgets[i])
        assert all(0 <= t < args.vocab for t in toks)


def run_wave(label: str, argv) -> tuple:
    """Serve the worker's waves with both kernels' counts set to 0 just
    before; returns (result, args, K1 launches, K2 launches, peak)."""
    import torch

    from kubegpu_tpu_torch.models import worker
    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention,
        paged_decode_attention,
    )

    args = worker.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention.launches = 0
    paged_chunk_attention.launches = 0
    r = worker.run_decode(args)
    k1, k2 = paged_decode_attention.launches, paged_chunk_attention.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {r['requests']} requests, {r['tokens']} tokens in "
        f"{r['wave_s']:.3f} s -> {r['tokens_per_sec']:.1f} tok/s; TTFT mean "
        f"{r['ttft_mean_s'] * 1e3:.1f} ms max {r['ttft_max_s'] * 1e3:.1f} ms; "
        f"first wave done {r['first_decode_s']:.1f} s after start; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    check_wave(r, args)
    return r, args, k1, k2, peak


def phase_flagship() -> dict:
    r, args, launches, k2, peak = run_wave("flagship", FLAGSHIP_ARGV)
    log(f"flagship: K1 launches {launches} = decode steps "
        f"{r['decode_steps_total']} x layers {args.layers}; K2 launches "
        f"{k2}")
    assert launches > 0 and launches == r["decode_steps_total"] * args.layers
    assert k2 == 0
    return dict(r, launches=launches, peak_bytes=peak)


def phase_spec_flagship() -> dict:
    r, args, k1, launches, peak = run_wave(
        "speculative flagship",
        FLAGSHIP_ARGV + ["--speculate", "--spec-k", str(SPEC_K)])
    steps = r["spec_steps_total"]
    log(f"speculative flagship: k={SPEC_K}, timed wave {r['spec_steps']} "
        f"verify steps for {r['spec_tokens']} tokens = "
        f"{r['spec_tokens'] / r['spec_steps']:.3f} tokens a verify; "
        f"draft ring wraps {r['draft_wraps']}; K2 launches {launches} = "
        f"verify steps {steps} x layers {args.layers}; K1 launches {k1}")
    assert launches > 0 and launches == steps * args.layers
    assert k1 == 0, "the speculative path must never run the plain step"
    assert r["spec_tokens"] == r["tokens"]
    return dict(r, launches=launches, peak_bytes=peak)


def phase_card_vs_cpu() -> dict:
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
    from kubegpu_tpu_torch.models.paging import (
        PagedContinuousBatcher,
        PagedDecodeLM,
    )
    from kubegpu_tpu_torch.models.params import bind_params, init_params, tree_map

    cfg = dict(vocab_size=512, num_layers=2, num_heads=2, hidden=256,
               max_seq=97)
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         torch.float32, "cpu")
    on = {"cpu": params,
          "cuda": tree_map(lambda t: t.to("cuda"), params)}
    # first-step logits: the dense prefill and one paged decode step
    rng = np.random.RandomState(3)
    hd = cfg["hidden"] // cfg["num_heads"]
    pools_np = [rng.randn(2, 6, 2, 16, hd).astype(np.float32) * 0.3
                for _ in range(cfg["num_layers"])]
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    pos = np.array([40, 17], np.int32)
    tokens = rng.randint(0, 512, size=(2, 1)).astype(np.int32)
    prompt = rng.randint(0, 512, size=(2, 24)).astype(np.int32)
    logits = {}
    for d in ("cpu", "cuda"):
        paged = bind_params(PagedDecodeLM(dtype=torch.float32, **cfg), on[d])
        pools = [(torch.from_numpy(p[0]).to(d), torch.from_numpy(p[1]).to(d))
                 for p in pools_np]
        step = paged(torch.from_numpy(tokens).to(d), pools,
                     torch.from_numpy(table).to(d), torch.from_numpy(pos).to(d))
        dense = bind_params(DecodeLM(dtype=torch.float32, **cfg), on[d])
        caches = init_caches(2, cfg["num_layers"], cfg["num_heads"],
                             cfg["hidden"], cfg["max_seq"], torch.float32, d)
        pre = dense(torch.from_numpy(prompt).to(d), caches, 0)
        logits[d] = (step.cpu(), pre.cpu())
    for i, name in enumerate(("paged step", "dense prefill")):
        a, c = logits["cuda"][i], logits["cpu"][i]
        assert torch.isfinite(a).all() and a.shape == c.shape
        log(f"card vs cpu {name} logits: max abs diff "
            f"{(a - c).abs().max().item():.3e}")
        torch.testing.assert_close(a, c, rtol=CARD_CPU_LOGIT_TOL,
                                   atol=CARD_CPU_LOGIT_TOL)
    # the batcher on both devices: shared prefixes, more requests than
    # slots, a token budget
    shared = rng.randint(0, 512, size=20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, size=n)]).astype(
        np.int32) if i % 2 == 0 else rng.randint(0, 512, size=n + 4).astype(
        np.int32) for i, n in enumerate((5, 9, 3, 11, 7, 1, 12, 6))]
    budgets = [24, 17, 30, 9, 28, 20, 13, 25]
    kw = dict(cfg, slots=4, prompt_pad=32, page_size=16, pool_pages=20,
              token_budget=40, dtype=torch.float32)
    streams = {}
    for d, pipe in (("cpu", True), ("cuda", True), ("cuda", False)):
        cb = PagedContinuousBatcher(params, device=d, pipeline_decode=pipe,
                                    **kw)
        streams[(d, pipe)] = cb.run(prompts, budgets)
        cb.assert_page_accounting()
        log(f"batcher {d} pipeline={pipe}: prefix hit tokens "
            f"{cb.stats['prefix_hit_tokens']}, steps {cb.stats['steps']}")
    assert streams[("cuda", True)] == streams[("cuda", False)], (
        "pipelined and synchronous card streams differ")
    cpu, card = streams[("cpu", True)], streams[("cuda", True)]
    dense = bind_params(DecodeLM(dtype=torch.float32, **cfg), params)
    agree, total = near_tie_agreement("card and cpu", cfg, dense, prompts,
                                      cpu, card)
    log(f"card vs cpu streams: {agree}/{total} tokens agree before any "
        "near-tie divergence")
    return dict(cfg=cfg, params=params, dense=dense, prompts=prompts,
                budgets=budgets, kw=kw, card=card)


def near_tie_agreement(label: str, cfg: dict, dense, prompts, ref: dict,
                       other: dict) -> tuple:
    """Compare two stream sets request by request: at the first token
    where ``other`` leaves ``ref``, the float32 dense model on the CPU
    must put ``ref``'s top two logits within NEAR_TIE_MARGIN (a near-tie
    that rounding may flip), or the divergence is a fault.  Returns
    (tokens agreeing before any divergence, tokens)."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import init_caches

    agree = total = 0
    for i in sorted(ref):
        a, c = other[i], ref[i]
        total += len(c)
        t = next((j for j in range(len(c)) if a[j] != c[j]), None)
        if t is None:
            agree += len(c)
            continue
        agree += t
        seq = np.concatenate([prompts[i], np.asarray(c[:t], np.int32)])
        caches = init_caches(1, cfg["num_layers"], cfg["num_heads"],
                             cfg["hidden"], cfg["max_seq"], torch.float32)
        with torch.no_grad():
            row = dense(torch.from_numpy(seq)[None], caches, 0)[0]
        top2 = torch.topk(row, 2).values
        margin = (top2[0] - top2[1]).item()
        log(f"request {i}: {label} diverge at token {t} "
            f"(cpu margin {margin:.3e})")
        assert margin <= NEAR_TIE_MARGIN, (
            f"request {i} diverged at token {t} with margin {margin}")
        log(f"request {i}: near-tie, not a fault")
    return agree, total


def phase_spec_card(ctx: dict) -> None:
    """Greedy speculation on the card against the card's plain streams
    (phase 6's model and traffic), for a hopeless draft (a fresh
    1-layer model) and a perfect one (the target itself)."""
    import torch

    from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
    from kubegpu_tpu_torch.models.params import init_params

    cfg, params = ctx["cfg"], ctx["params"]
    hopeless_cfg = dict(vocab_size=cfg["vocab_size"], num_layers=1,
                        hidden=64, max_seq=cfg["max_seq"])
    drafts = {
        "hopeless": (init_params(hopeless_cfg,
                                 torch.Generator().manual_seed(5),
                                 torch.float32, "cpu"),
                     dict(draft_num_layers=1, draft_num_heads=2,
                          draft_hidden=64)),
        "perfect": (params, dict(draft_num_layers=cfg["num_layers"],
                                 draft_num_heads=cfg["num_heads"],
                                 draft_hidden=cfg["hidden"])),
    }
    for k in (2, 4):
        verify_steps = {}
        for name, (dparams, dims) in drafts.items():
            streams = {}
            for pipe in (True, False):
                cb = PagedContinuousBatcher(
                    params, device="cuda", pipeline_decode=pipe,
                    draft_params=dparams, speculate_k=k, **dims,
                    **ctx["kw"])
                streams[pipe] = cb.run(ctx["prompts"], ctx["budgets"])
                cb.assert_page_accounting()
                verify_steps[name] = cb.stats["spec_steps"]
                log(f"speculation k={k} {name} draft pipeline={pipe}: "
                    f"{cb.stats['spec_steps']} verify steps for "
                    f"{cb.stats['spec_tokens']} tokens, draft ring wraps "
                    f"{cb.stats['draft_wraps']}")
            assert streams[True] == streams[False], (
                f"k={k} {name}: pipelined and synchronous card streams "
                "differ")
            agree, total = near_tie_agreement(
                f"k={k} {name} speculation and the plain card batcher",
                cfg, ctx["dense"], ctx["prompts"], ctx["card"],
                streams[True])
            log(f"speculation k={k} {name} draft vs plain card streams: "
                f"{agree}/{total} tokens agree before any near-tie "
                "divergence")
        assert verify_steps["perfect"] < verify_steps["hopeless"], (
            f"k={k}: the perfect draft took {verify_steps['perfect']} "
            f"verify steps, the hopeless one {verify_steps['hopeless']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port must be importable before anything is printed: a copy of
    # this script without the repo fails here, with no result
    import kubegpu_tpu_torch.models.worker  # noqa: F401
    t0 = time.monotonic()
    name = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    flag = phase_flagship()
    spec = phase_spec_flagship()
    phase_spec_card(phase_card_vs_cpu())
    log(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")
    source = "kubegpu_tpu_torch/ops/csrc/paged_attention.cu"
    kernels = []
    for kname, replaces, rec, run in (
        ("paged_decode_attention", "kubegpu_tpu/ops/paged_attention.py:135",
         k1, flag),
        ("paged_chunk_attention", "kubegpu_tpu/ops/paged_attention.py:390",
         k2, spec),
    ):
        bf = rec["bfloat16"]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": run["launches"],
            "max_abs_err": bf["max_abs_err"],
            "ms": bf["ms"],
            "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"],
            "bound_by": bf.get("bound_by", "bytes"),
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
