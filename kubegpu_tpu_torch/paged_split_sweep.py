"""The split plan of the paged kernels, and K1's ring, swept on the card.

    python -m kubegpu_tpu_torch.paged_split_sweep

Times K1, K1q, K2 and K2q (bf16 q; K1q/K2q over int8 pools from
``quantize_pages``) from replayed CUDA graphs at the serving geometries
of ``chip_smoke.py`` phases 2-3 and 11-12: the flagship's (8 slots, 32
heads of 128, pages of 128, 9-page tables, a 5-row K2 window) and the
worker's defaults' (8 heads of 64, pages of 32, 36-page tables, a 9-row
window), at the smoke's lengths (the profile also takes K1 at the
flagship with every slot at 130-158 rows, the steady decode step's
contexts: one split a row).  Each pages-per-split S in ``SPLITS`` is
tried for all four kernels and, for K1/K1q, each ring in ``RINGS`` (tile
bytes, ring bytes), by swapping ``paged_attention.split_plan`` at run
time: the kernels take the plan as arguments, so nothing is rebuilt.
Every variant is first held against the plain twin (bf16: rtol 2^-7,
atol 1e-5), and K2's rows against K1 at lengths + j bit for bit; then
the variants are timed in turns (forward, reversed, forward).  Last,
under the committed plan, ``torch.profiler`` splits each kernel's device
time between its walk and the merge pass.  Needs one CUDA device; prints
the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from kubegpu_tpu_torch.k3_variants import graph_ms
from kubegpu_tpu_torch.ops import paged_attention as pa

SPLITS = (1, 2, 4, 8, 16, 36)
# K1's ring: (tile bytes, ring bytes)
RINGS = ((32 * 1024, 64 * 1024), (16 * 1024, 64 * 1024),
         (16 * 1024, 32 * 1024), (8 * 1024, 32 * 1024))
GEOMETRIES = {"flagship": dict(h=32, hd=128, page=128, L=5),
              "defaults": dict(h=8, hd=64, page=32, L=9)}
SLOTS, CONTEXT_ROWS = 8, 1152


def operands(geo: dict, quant: bool, seed: int) -> dict:
    """The smoke's K1 and K2 inputs at one geometry: q rows, pools (int8
    with scales if ``quant``), a shuffled table, K1's and K2's lengths."""
    h, hd, page, L = geo["h"], geo["hd"], geo["page"], geo["L"]
    n_pages = CONTEXT_ROWS // page
    pool = SLOTS * n_pages + 8
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.stack([torch.randperm(pool, generator=g, device="cuda")
                         [:n_pages] for _ in range(SLOTS)]).to(torch.int32)
    kp, vp = (torch.randn((pool, h, page, hd), generator=g, device="cuda")
              * 0.3 for _ in range(2))
    if quant:
        (kp, ks), (vp, vs) = pa.quantize_pages(kp), pa.quantize_pages(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, sc = kp.to(torch.bfloat16), vp.to(torch.bfloat16), {}
    full = n_pages * page

    def lengths(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    return dict(
        q1=torch.randn((SLOTS, h, hd), generator=g, device="cuda").to(
            torch.bfloat16),
        q2=torch.randn((SLOTS, L, h, hd), generator=g, device="cuda").to(
            torch.bfloat16),
        kp=kp, vp=vp, sc=sc, table=table,
        len1=lengths([0, 1, page - 1, page, 200, 513, 1000, full]),
        len2=lengths([1, page - 4, page - 2, page - 1, page, 513, 1000,
                      full - (L - 1)]))


def plan_for(split: int, ring):
    """A split_plan that answers ``split`` pages and K1's ring ``ring``."""
    def plan(page, hd, dtype, quant):
        _, tile, stages, smem = pa._ring_plan(page, hd, dtype, quant, 1, *ring)
        return split, tile, stages, smem
    return plan


def check(x: dict) -> None:
    """K1 and K2 under the current plan against their twins; K2's rows
    equal K1 at lengths + j."""
    one = pa.paged_decode_attention(x["q1"], x["kp"], x["vp"], x["table"],
                                    x["len1"], **x["sc"])
    torch.testing.assert_close(
        one.float(), pa.paged_decode_attention_plain(
            x["q1"], x["kp"], x["vp"], x["table"], x["len1"],
            **x["sc"]).float(), rtol=2 ** -7, atol=1e-5)
    win = pa.paged_chunk_attention(x["q2"], x["kp"], x["vp"], x["table"],
                                   x["len2"], **x["sc"])
    torch.testing.assert_close(
        win.float(), pa.paged_chunk_attention_plain(
            x["q2"], x["kp"], x["vp"], x["table"], x["len2"],
            **x["sc"]).float(), rtol=2 ** -7, atol=1e-5)
    for j in range(x["q2"].shape[1]):
        assert torch.equal(win[:, j], pa.paged_decode_attention(
            x["q2"][:, j].contiguous(), x["kp"], x["vp"], x["table"],
            x["len2"] + j, **x["sc"])), j


def passes_us(call, n: int = 20) -> dict:
    """Mean device time of each kernel one ``call()`` launches (the walk,
    the merge), from torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        if "paged_" in ev.key:
            name = ev.key.split("<")[0].split()[-1]
            times[name] = times.get(name, 0.0) + ev.device_time_total / n
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    default_plan = pa.split_plan
    runs = []   # (label, plan, timed call)
    calls = {}  # label -> the committed plan's K1 and K2 calls
    steady = None  # the flagship's bf16 operands, at steady contexts
    for gname, geo in GEOMETRIES.items():
        for quant in (False, True):
            x = operands(geo, quant, seed=len(runs))
            if steady is None:
                # every slot 130-158 rows, two pages: one split a row
                steady = dict(x, len1=torch.arange(
                    130, 162, 4, dtype=torch.int32, device="cuda"))
            k1, k2 = ("K1q", "K2q") if quant else ("K1", "K2")

            def call_k1(x=x):
                pa.paged_decode_attention(x["q1"], x["kp"], x["vp"],
                                          x["table"], x["len1"], **x["sc"])

            def call_k2(x=x):
                pa.paged_chunk_attention(x["q2"], x["kp"], x["vp"],
                                         x["table"], x["len2"], **x["sc"])

            calls[f"{gname} {k1}"], calls[f"{gname} {k2}"] = call_k1, call_k2
            for split in SPLITS:
                for i, ring in enumerate(RINGS):
                    plan = plan_for(split, ring)
                    pa.split_plan = plan
                    check(x)
                    runs.append((f"{gname} {k1} S {split} ring {ring[0] >> 10}"
                                 f"/{ring[1] >> 10} KB", plan, call_k1))
                    if i == 0:
                        runs.append((f"{gname} {k2} S {split}", plan, call_k2))
    times = {label: [] for label, _, _ in runs}
    for order in (runs, runs[::-1], runs):
        for label, plan, call in order:
            pa.split_plan = plan
            times[label].append(graph_ms(call, n=20))
    pa.split_plan = default_plan
    for label, ms in times.items():
        print(f"{label}: " + ", ".join(f"{t * 1e3:.2f}" for t in ms) + " us",
              flush=True)
    calls["steady flagship K1"] = lambda: pa.paged_decode_attention(
        steady["q1"], steady["kp"], steady["vp"], steady["table"],
        steady["len1"])
    passes = {}
    for label, call in calls.items():
        passes[label] = passes_us(call)
        print(f"{label}, committed plan, device time a call: " + ", ".join(
            f"{name} {us:.2f} us" for name, us in passes[label].items()),
            flush=True)
    print(json.dumps({"graph_us": {label: [t * 1e3 for t in ms]
                                   for label, ms in times.items()},
                      "profiled_us": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
