"""Where a steady decode step's time goes on the card, at the flagship
LM's full width (the configuration ``chip_smoke.py`` serves).

    python -m kubegpu_tpu_torch.profile_serving [--speculate [--spec-k K]] \
        [--kv-dtype int8] [--int8] [--sample-temperature T [--sample-top-k K]]
    python -m kubegpu_tpu_torch.profile_serving --serving continuous [--int8]

Builds the worker's batcher (vocab 32768, hidden 4096, 4 layers, 32
heads, bf16, page 128, 8 slots; the extra arguments are the worker's, so
``--kv-dtype int8`` profiles the int8 pool with K1q/K2q, ``--int8``
weight-only int8, ``--sample-temperature`` sampled requests, slot i
pinning seed ``--sample-seed + i``, and ``--serving continuous`` the
dense ``ContinuousBatcher``, whose cache holds ``--seq + 1`` = 1025 rows
a slot), fills every slot with a 128-token prompt and a budget that
outlasts the measurement, and once all eight are decoding:

- times a window of serve_steps with the host clock around synchronized
  ends: ms per step and tokens/s at 8 active slots (with
  ``--speculate`` a step is a draft scan plus a verify window, and the
  tokens are those the window committed);
- profiles a second window of the same length with ``torch.profiler``:
  device time by kernel, the device's busy time and its idle share of
  the window's wall time, and the device kernels launched a step.

Needs one CUDA device; prints plain lines, the last a JSON summary.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher

FLAGSHIP = ["--model", "decode", "--serving", "paged", "--vocab", "32768",
            "--hidden", "4096", "--layers", "4", "--heads", "32",
            "--prompt-len", "128", "--page-size", "128",
            "--batch-per-chip", "8", "--steps", "512"]
WINDOW = 32


def steady_batcher(extra):
    args = worker.build_parser().parse_args(FLAGSHIP + extra)
    cb = worker.build_batcher(args)
    rng = np.random.RandomState(0)
    temp = args.sample_temperature
    for i in range(cb.slots):
        cb.submit(i, rng.randint(0, args.vocab, size=128, dtype=np.int32),
                  args.steps, temp,
                  seed=args.sample_seed + i if temp > 0 else None)
    # a sequence has a token only once its prefill finished
    live = {}
    while len(live) < cb.slots or not all(live.values()):
        cb.serve_step()
        live = cb.live_tokens()
    for _ in range(8):  # warm the steady loop
        cb.serve_step()
    return cb


def committed(cb) -> int:
    return sum(len(t) for t in cb.live_tokens().values())


def timed_window(cb):
    """(wall seconds, tokens committed) over WINDOW serve_steps."""
    torch.cuda.synchronize()
    n0 = committed(cb)
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        cb.serve_step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, committed(cb) - n0


def profiled_window(cb):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            cb.serve_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name[e.name]
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    return wall, dict(by_name)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device available", file=sys.stderr)
        return 2
    extra = sys.argv[1:] if argv is None else list(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    cb = steady_batcher(extra)
    wall, tokens = timed_window(cb)
    ms_step = wall / WINDOW * 1e3
    k = getattr(cb, "speculate_k", None)
    mode = (f"speculative k={k}" if k else "decode"
            if isinstance(cb, PagedContinuousBatcher) else "dense decode")
    print(f"steady {mode}: {cb.slots} active slots, {WINDOW} steps in "
          f"{wall * 1e3:.2f} ms -> {ms_step:.3f} ms/step, {tokens} tokens "
          f"({tokens / WINDOW:.2f} a step), {tokens / wall:.1f} tok/s",
          flush=True)
    pwall, kernels = profiled_window(cb)
    busy = sum(ms for ms, _ in kernels.values())
    summary = {"mode": mode, "ms_per_step": ms_step,
               "tok_per_s": tokens / wall, "tokens_per_step": tokens / WINDOW,
               "profiled_wall_ms": pwall * 1e3}
    if not kernels:
        print("profile: the profiler recorded no device events; busy time "
              "and idle share not measured", flush=True)
    else:
        idle = 1.0 - busy / (pwall * 1e3)
        # the profiler slows the host, so the unprofiled window is the
        # truer wall; both shares are printed
        idle_unprofiled = 1.0 - busy / (wall * 1e3)
        print(f"profile: device busy {busy:.2f} ms of {pwall * 1e3:.2f} ms "
              f"profiled wall ({busy / WINDOW:.3f} ms/step) -> idle share "
              f"{idle * 100:.1f}%; against the unprofiled window's "
              f"{ms_step:.3f} ms/step -> {idle_unprofiled * 100:.1f}%",
              flush=True)
        for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"  {ms / WINDOW * 1e3:9.1f} us/step {ms / busy * 100:5.1f}% "
                  f"x{n / WINDOW:5.1f}/step  {name[:90]}", flush=True)
        def by_name(part):
            return sum(ms for name, (ms, _) in kernels.items() if part in name)

        # the kernel names match the full-width and int8 instantiations; a
        # step runs K1's walk or K2's, each followed by the merge pass
        merge = by_name("paged_merge_kernel")
        k1 = by_name("paged_decode_walk_kernel")
        k2 = by_name("paged_chunk_walk_kernel")
        k1, k2 = (k1 + merge, k2) if k1 else (k1, k2 + merge)
        print(f"profile: K1/K1q {k1 / WINDOW * 1e3:.1f} us/step "
              f"({k1 / busy * 100:.1f}% of device time), K2/K2q "
              f"{k2 / WINDOW * 1e3:.1f} us/step ({k2 / busy * 100:.1f}%)",
              flush=True)
        launches = sum(n for _, n in kernels.values()) / WINDOW
        print(f"profile: {launches:.1f} device kernel launches a step",
              flush=True)
        summary.update(device_busy_ms_per_step=busy / WINDOW,
                       launches_per_step=launches,
                       idle_share=idle, idle_share_unprofiled=idle_unprofiled,
                       k1_us_per_step=k1 / WINDOW * 1e3,
                       k2_us_per_step=k2 / WINDOW * 1e3)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
