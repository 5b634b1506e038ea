"""Two design choices of the bf16 K3, measured on the card in one process.

    python -m kubegpu_tpu_torch.k3_variants

The committed ``ops/csrc/flash_attention.cu`` builds K3 with 128-row K/V
tiles (``kFwdKvRows``) and folds the softmax's scale into exp2's
multiply-add (the row max is taken on the unscaled scores).  This script
builds copies of the source that undo one choice each, under
``build/kubegpu_tpu_torch/``:

- ``64-row tiles``: ``kFwdKvRows = 64`` (S by ``wgmma_m64n64k16_ss``);
- ``scale first``: every score is scaled before the max, and exp2 takes
  the scaled score minus the shift.

It holds each build's bf16 out against the twin's emulation gates (as
``chip_smoke.py`` phase 8 does) at the training path's shapes, then
times the builds in turns (source, variants, variants reversed, source;
three times) from replayed CUDA graphs.  Needs one CUDA device; prints
the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

from kubegpu_tpu_torch.ops import _build, attention

SHAPE = (16, 1024, 32, 128)   # b, s, heads, head_dim: the training path's
# name -> the source edits that make the variant (each text occurs once)
VARIANTS = {
    "64-row tiles": [("constexpr int kFwdKvRows = 128;",
                      "constexpr int kFwdKvRows = 64;"),
                     ("wgmma_m64n128k16_ss(", "wgmma_m64n64k16_ss(")],
    "scale first": [
        ("      const int a = half_of(e), c = col_of(e);\n"
         "      if (masked",
         "      const int a = half_of(e), c = col_of(e);\n"
         "      sc[e] *= scale_log2;\n"
         "      if (masked"),
        ("fmaxf(m[a], mx[a] * scale_log2)", "fmaxf(m[a], mx[a])"),
        ("exp2_ftz(fmaf(sc[e], scale_log2, -shift[half_of(e)]))",
         "exp2_ftz(sc[e] - shift[half_of(e)])"),
    ],
}


def build_variant(name: str) -> ctypes.CDLL:
    """The flash library built from a copy of the source with the
    variant's edits."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / ("k3_" + name.replace(" ", "_"))
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(src)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    lib = out / "libflash_attention.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(out / "flash_attention.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(
            f"{name}: nvcc failed:\n{built.stdout}{built.stderr}")
    handle = ctypes.CDLL(str(lib))
    attention._declare(handle)
    return handle


def gate_shares(q, k, v) -> tuple:
    """(out's error against the f32 twin as a share of its allowance,
    worst element share, worst 64-row block share) of the loaded K3."""
    out, _ = attention.flash_forward(q, k, v, True)
    ref, _ = attention.flash_forward_plain(*(t.float() for t in (q, k, v)),
                                           True)
    emu, _ = attention.flash_forward_plain(q, k, v, True,
                                           operand_dtype=torch.bfloat16)
    err = (out.float() - ref).abs().max().item()
    allow = attention.bf16_gradient_allowance(
        (emu.float() - ref).abs().max().item())
    return (err / allow, *attention.bf16_emulation_shares(out, emu))


def graph_ms(fn, n: int = 4, replays: int = 10) -> float:
    """Device time of one ``fn()``: n calls captured in one CUDA graph,
    replayed."""
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
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * n)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    libs = {"source": _build.load("flash_attention")}
    libs.update((name, build_variant(name)) for name in VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(4)
    b, s, h, d = SHAPE
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    summary = {}
    for name, lib in libs.items():
        _build._LOADED["flash_attention"] = lib
        shares = gate_shares(q, k, v)
        print(f"K3 bf16 {name}: out at {shares[0]:.3f} of its allowance "
              f"against the f32 twin, worst element {shares[1]:.3f} and "
              f"64-row block {shares[2]:.3f} against the emulation",
              flush=True)
        if max(shares) > 1:
            raise AssertionError(f"{name} fails the gates: {shares}")
        summary[name] = {"gate_shares": shares, "ms": []}
    order = list(libs)
    for name in (order + order[::-1]) * 3:
        _build._LOADED["flash_attention"] = libs[name]
        summary[name]["ms"].append(
            graph_ms(lambda: attention.flash_forward(q, k, v, True)))
    _build._LOADED["flash_attention"] = libs["source"]
    for name, rec in summary.items():
        print(f"K3 bf16 {name}, b{b} s{s} h{h} d{d} causal: "
              + ", ".join(f"{t:.4f}" for t in rec["ms"]) + " ms", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
