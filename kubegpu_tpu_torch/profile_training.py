"""Where a steady training step's time goes on the card, at the flagship
LM's full width (the configuration ``chip_smoke.py`` trains).

    python -m kubegpu_tpu_torch.profile_training [worker flags ...]

Builds the worker's ``--model lm`` trainer (vocab 32768, hidden 4096, 4
layers, 32 heads, seq 1024, batch 16, bf16 compute over float32
weights, flash attention; extra worker flags such as ``--attn-impl
einsum`` or ``--remat`` override these), takes two warm-up steps, then:

- times a window of steps with the host clock around synchronized ends:
  ms per step and tokens/s;
- profiles a second window of the same length with ``torch.profiler``:
  device time by kernel, the device's busy time and its idle share of
  the window's wall time, and the share of the flash-attention kernels
  (K3, K4, K5 and the backward's delta pre-pass).

Needs one CUDA device; prints plain lines, the last a JSON summary.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.train import lm_step

FLAGSHIP = ["--model", "lm", "--vocab", "32768", "--hidden", "4096",
            "--layers", "4", "--heads", "32", "--seq", "1024",
            "--batch-per-chip", "16"]
WINDOW = 4
# kernel-name fragments of K3, K4 and K5 in ops/csrc/flash_attention.cu:
# each runs as the float32 kernel or, in bf16, the tensor-core (wgmma)
# kernel (K4 and K5 after the delta pre-pass)
FLASH_KERNELS = ("flash_forward_kernel", "flash_forward_wgmma_kernel",
                 "flash_backward_dkdv_kernel", "flash_backward_dq_kernel",
                 "flash_backward_dkdv_wgmma_kernel",
                 "flash_backward_dq_wgmma_kernel",
                 "flash_backward_delta_kernel")


def timed_window(state, next_batch):
    """Wall seconds of WINDOW steps, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOW):
        lm_step(state, next_batch())
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled_window(state, next_batch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            lm_step(state, next_batch())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # a user annotation (the optimizer's step range) spans kernels
        # already counted
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            rec = by_name[e.name]
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    return wall, dict(by_name)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device available", file=sys.stderr)
        return 2
    extra = sys.argv[1:] if argv is None else list(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = worker.build_parser().parse_args(FLAGSHIP + extra)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    state, next_batch = worker.build_trainer(args)
    for _ in range(2):  # warm-up: kernel builds, cuBLAS plans, allocator
        lm_step(state, next_batch())
    wall = timed_window(state, next_batch)
    tokens = args.batch_per_chip * args.seq
    ms_step = wall / WINDOW * 1e3
    print(f"steady training ({args.attn_impl} attention"
          f"{', remat' if args.remat else ''}): {WINDOW} steps in "
          f"{wall * 1e3:.2f} ms -> {ms_step:.3f} ms/step, "
          f"{tokens * WINDOW / wall:.1f} tokens/s", flush=True)
    pwall, kernels = profiled_window(state, next_batch)
    summary = {"attn_impl": args.attn_impl, "remat": args.remat,
               "ms_per_step": ms_step,
               "tokens_per_sec": tokens * WINDOW / wall,
               "profiled_wall_ms": pwall * 1e3}
    if not kernels:
        print("profile: the profiler recorded no device events; busy time "
              "and idle share not measured", flush=True)
    else:
        busy = sum(ms for ms, _ in kernels.values())
        idle = 1.0 - busy / (pwall * 1e3)
        idle_unprofiled = 1.0 - busy / (wall * 1e3)
        print(f"profile: device busy {busy:.2f} ms of {pwall * 1e3:.2f} ms "
              f"profiled wall ({busy / WINDOW:.3f} ms/step) -> idle share "
              f"{idle * 100:.1f}%; against the unprofiled window's "
              f"{ms_step:.3f} ms/step -> {idle_unprofiled * 100:.1f}%",
              flush=True)
        for name, (ms, n) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:20]:
            print(f"  {ms / WINDOW:9.3f} ms/step {ms / busy * 100:5.1f}% "
                  f"x{n / WINDOW:5.1f}/step  {name[:90]}", flush=True)
        flash = {frag: sum(ms for name, (ms, _) in kernels.items()
                           if frag in name) for frag in FLASH_KERNELS}
        attn = sum(flash.values())
        print("profile: " + ", ".join(
            f"{frag} {ms / WINDOW:.3f} ms/step" for frag, ms in flash.items())
            + f"; flash attention {attn / busy * 100:.1f}% of device time",
            flush=True)
        summary.update(device_busy_ms_per_step=busy / WINDOW,
                       idle_share=idle, idle_share_unprofiled=idle_unprofiled,
                       flash_ms_per_step={k: v / WINDOW
                                          for k, v in flash.items()},
                       flash_share=attn / busy)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
