"""The port's worker (kubegpu_tpu_torch/models/worker.py) on the CPU at a
tiny width: as a subprocess it prints the JAX worker's FIRST_DECODE_DONE
/ DECODE_DONE lines and a K1 launch count of 0 (the CPU takes the
kernel's plain twin); in process it serves every request of a wave to
its budget.  ``--tp 2 --device cpu`` serves the same wave over two
gloo ranks (``SERVING_TP``), and refuses what the JAX worker refuses.
``--model lm`` trains and prints FIRST_STEP_DONE and steady_state with
zero flash-kernel launches; ``--tp 2 --cpu-ranks 4 --device cpu`` trains
on a ``("data", "model")`` mesh of four gloo ranks (``TRAINING_MESH
data=2 model=2``) and the JAX worker's mesh refusals hold;
``--attn-impl ring|ulysses`` train as flash (``--model lm-cp`` is in
``tests/test_torch_cp_train.py``)."""

import os
import re
import subprocess
import sys
import time

import pytest
import torch

from kubegpu_tpu_torch.models import worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "decode", "--serving", "paged", "--vocab", "64",
        "--hidden", "32", "--heads", "4", "--layers", "2", "--seq", "64",
        "--prompt-len", "16", "--page-size", "8", "--batch-per-chip", "2",
        "--steps", "8"]


def run_worker(*extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *TINY,
         *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_worker_subprocess_on_cpu_prints_done_lines():
    proc = run_worker("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(r"^FIRST_DECODE_DONE seconds=[\d.]+$", out, re.M)
    done = re.search(
        r"^DECODE_DONE tokens_per_sec=[\d.]+ serving=paged requests=4 "
        r"steps=(\d+) admits=4$", out, re.M)
    assert done and int(done.group(1)) > 0, out
    k1 = re.search(r"^K1_LAUNCHES paged_decode_attention=(\d+) "
                   r"decode_steps=(\d+) layers=2 device=cpu "
                   r"K1Q_LAUNCHES paged_decode_attention_int8=(\d+) "
                   r"kv_dtype=bfloat16$", out, re.M)
    assert k1, out
    assert int(k1.group(1)) == 0 and int(k1.group(2)) > 0
    assert int(k1.group(3)) == 0


def test_worker_run_decode_serves_every_request_to_its_budget():
    args = worker.build_parser().parse_args(TINY + ["--device", "cpu",
                                                    "--serve-fp32"])
    r = worker.run_decode(args)
    budgets = [max(8 * (1 + i % 4) // 4, 1) for i in range(4)]
    assert sorted(r["outputs"]) == [0, 1, 2, 3]
    for i, toks in r["outputs"].items():
        assert len(toks) == budgets[i]
        assert all(0 <= t < 64 for t in toks)
    assert r["tokens"] == sum(budgets)
    assert r["k1_launches"] == 0
    assert r["ttft_mean_s"] is not None and r["ttft_mean_s"] >= 0


def test_worker_wave_draws_prompts_like_the_jax_worker():
    import numpy as np

    rng = np.random.RandomState(0)
    prompts = worker.wave_requests(rng, 4, 64, 16)
    ref = np.random.RandomState(0)
    for p in prompts:
        want = ref.randint(0, 64, size=ref.randint(1, 17), dtype=np.int32)
        np.testing.assert_array_equal(p, want)


@pytest.mark.parametrize("bad, match", [
    (["--steps", "60"], "exceeds"),
    (["--page-size", "5"], "divide"),
])
def test_worker_refuses_bad_geometry(bad, match):
    args = worker.build_parser().parse_args(TINY + ["--device", "cpu"] + bad)
    with pytest.raises(SystemExit, match=match):
        worker.run_decode(args)


def test_worker_speculative_streams_equal_the_plain_workers():
    """--speculate at fp32 serves the same wave token for token: greedy
    verification is lossless for any draft (here a fresh 1-layer one)."""
    base = TINY + ["--device", "cpu", "--serve-fp32"]
    plain = worker.run_decode(worker.build_parser().parse_args(base))
    spec = worker.run_decode(worker.build_parser().parse_args(
        base + ["--speculate", "--spec-k", "2"]))
    assert spec["outputs"] == plain["outputs"]
    assert spec["spec_steps"] > 0 and plain["spec_steps"] == 0
    assert spec["spec_tokens"] == spec["tokens"] == plain["tokens"]
    assert spec["k1_launches"] == spec["k2_launches"] == 0


def test_worker_speculative_subprocess_prints_spec_steps():
    proc = run_worker("--device", "cpu", "--serve-fp32", "--speculate",
                      "--spec-k", "2")
    assert proc.returncode == 0, proc.stderr
    spec = re.search(r"^SPEC_DONE spec_steps=(\d+) spec_tokens=(\d+) "
                     r"draft_wraps=\d+ k=2 K2_LAUNCHES "
                     r"paged_chunk_attention=0 spec_steps_total=\d+ "
                     r"K2Q_LAUNCHES paged_chunk_attention_int8=0$",
                     proc.stdout, re.M)
    assert spec, proc.stdout
    assert int(spec.group(1)) > 0 and int(spec.group(2)) > 0


@pytest.mark.parametrize("bad, match", [
    (["--steps", "47", "--spec-k", "4"], "headroom"),
    (["--draft-hidden", "257"], "divisible"),
])
def test_worker_refuses_bad_speculation_geometry(bad, match):
    args = worker.build_parser().parse_args(
        TINY + ["--device", "cpu", "--speculate"] + bad)
    with pytest.raises(SystemExit, match=match):
        worker.run_decode(args)


LM_TINY = ["--model", "lm", "--vocab", "61", "--hidden", "32", "--heads",
           "4", "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
           "--steps", "3"]


def test_lm_worker_subprocess_on_cpu_prints_step_lines():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *LM_TINY,
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    for k, name in (("K3", "flash_forward"), ("K4", "flash_backward_dkdv"),
                    ("K5", "flash_backward_dq"),
                    ("DELTA", "flash_backward_delta")):
        assert re.search(rf"^{k}_LAUNCHES {name}=0 steps=3 layers=2 "
                         r"device=cpu$", out, re.M), out
    assert re.search(r"^PEAK_MEM_GIB not measured device=cpu$", out, re.M)


@pytest.mark.parametrize("extra", [
    ["--data", "synthetic", "--data-pool", "2"],
    ["--data", "stream", "--attn-impl", "einsum"],
    ["--data", "resident", "--remat"],
])
def test_lm_worker_trains_in_every_data_mode(extra):
    args = worker.build_parser().parse_args(LM_TINY + ["--device", "cpu"]
                                            + extra)
    r = worker.run_lm(args)
    assert len(r["losses"]) == 3
    assert all(0.0 < x < 10.0 for x in r["losses"])
    assert r["tokens_per_step"] == 2 * 16
    assert r["k3_launches"] == r["k4_launches"] == r["k5_launches"] == 0
    assert r["delta_launches"] == 0


def test_lm_worker_draws_the_jax_workers_batches():
    """The first batch of a pool sizes the JAX init; step i trains on
    the source's batch i + 1, in the pool as in the stream."""
    import numpy as np

    from kubegpu_tpu_torch.models.data import synthetic_token_batches

    args = worker.build_parser().parse_args(LM_TINY + ["--device", "cpu"])
    for mode in ("synthetic", "stream"):
        args.data = mode
        source = synthetic_token_batches(2, 17, 61)
        batches, first = worker.make_batches(args, source, "cpu")
        ref = synthetic_token_batches(2, 17, 61)
        np.testing.assert_array_equal(first.numpy(), next(ref))
        for _ in range(3):
            np.testing.assert_array_equal(next(batches).numpy(), next(ref))


@pytest.mark.parametrize("bad, match", [
    # --tp 2 now trains over a mesh, so on one CPU rank it exceeds the
    # device count; the case keeps the name it had when it waited for
    # its slice
    pytest.param(["--tp", "2"], "exceeds the visible device count 1",
                 id="bad0-data x tensor-parallel training slice"),
    # --attn-impl ring|ulysses now train as flash (no "seq" axis), as in
    # JAX; these cases keep their names and hold the refusals of the
    # context-parallel slice that arrived instead
    pytest.param(["--model", "lm-cp", "--cp", "2"],
                 "--cp 2 exceeds the visible device count 1",
                 id="bad1-long-context slice"),
    pytest.param(["--model", "lm-cp", "--cpu-ranks", "2", "--seq", "15"],
                 "--seq 15 not divisible by cp=2",
                 id="bad2-long-context slice"),
    (["--heads", "5"], "divisible"),
])
def test_lm_worker_refuses_what_waits_for_a_later_slice(bad, match):
    args = worker.build_parser().parse_args(LM_TINY + ["--device", "cpu"]
                                            + bad)
    with pytest.raises(SystemExit, match=match):
        worker.run_lm(args)


def test_lm_worker_trains_dp2_tp2_over_four_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", "--model",
         "lm", "--vocab", "64", "--hidden", "32", "--heads", "4", "--layers",
         "2", "--seq", "16", "--batch-per-chip", "2", "--steps", "3",
         "--tp", "2", "--cpu-ranks", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(r"^TRAINING_MESH data=2 model=2 devices=cpu,cpu,cpu,cpu "
                     r"backend=gloo$", out, re.M), out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    # global tokens: 2 rows a data rank x 2 data ranks x 16 positions
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    for rank in range(4):
        assert re.search(rf"^K3_LAUNCHES flash_forward=0 steps=3 layers=2 "
                         rf"device=cpu rank={rank}$", out, re.M), out
        assert re.search(rf"^PEAK_MEM_GIB not measured device=cpu "
                         rf"rank={rank}$", out, re.M), out


def test_lm_worker_mesh_run_returns_every_rank():
    args = worker.build_parser().parse_args(
        LM_TINY + ["--device", "cpu", "--cpu-ranks", "2", "--vocab", "64",
                   "--data", "resident"])
    r = worker.run_lm(args)
    # --tp 0: every rank on the "model" axis
    assert r["mesh"] == {"data": 1, "model": 2}
    assert len(r["ranks"]) == 2 and len(r["losses"]) == 3
    assert r["tokens_per_step"] == 2 * 16
    assert all(0.0 < x < 10.0 for x in r["losses"])


@pytest.mark.parametrize("bad, match", [
    (["--tp", "3", "--cpu-ranks", "4"], "does not divide the device count 4"),
    (["--tp", "8", "--cpu-ranks", "4"], "exceeds the visible device count 4"),
    (["--tp", "2", "--cpu-ranks", "2", "--heads", "5", "--hidden", "40"],
     "--heads 5 not divisible by tp=2"),
    (["--tp", "2", "--cpu-ranks", "2"], "--vocab 61 not divisible by tp=2"),
    (["--tp", "2", "--cpu-ranks", "2", "--vocab", "64", "--seq", "15"],
     "--seq 15 not divisible by tp=2"),
    (["--cpu-ranks", "0"], "at least one rank"),
])
def test_lm_worker_mesh_refusals(bad, match):
    args = worker.build_parser().parse_args(LM_TINY + ["--device", "cpu"]
                                            + bad)
    with pytest.raises(SystemExit, match=match):
        worker.run_lm(args)


def test_cpu_ranks_is_the_cpus_stand_in_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = worker.build_parser().parse_args(LM_TINY + ["--cpu-ranks", "4"])
    with pytest.raises(SystemExit, match="only with --device cpu"):
        worker.training_mesh(args)
    # on the card the device count is the cards': --tp 2 on one card
    args = worker.build_parser().parse_args(LM_TINY + ["--tp", "2"])
    with pytest.raises(SystemExit, match="exceeds the visible device count 1"):
        worker.training_mesh(args)
    with pytest.raises(SystemExit, match=r"\|lm\|lm-cp --device cpu only"):
        worker.main(TINY + ["--device", "cpu", "--cpu-ranks", "2"])


@pytest.mark.parametrize("bad", [
    ["--serving", "continuous", "--kv-dtype", "int8"],
    ["--serve-fp32", "--kv-dtype", "bf16"],
], ids=["kv-dtype-off-the-paged-path", "contradictory-pair"])
def test_worker_cli_rejects_bad_kv_dtype(bad):
    """Mirror of tests/test_quantized_pool.py's worker refusals: the KV
    storage knob belongs to the paged path, and a full-width name must
    match the serving dtype."""
    with pytest.raises(SystemExit):
        worker.main(TINY + ["--device", "cpu"] + bad)


def test_worker_cli_serves_paged_int8(capsys):
    rc = worker.main(TINY + ["--device", "cpu", "--kv-dtype", "int8",
                             "--int8", "--decode-page-cache", "quantized"])
    assert rc == 0
    out = capsys.readouterr().out
    assert re.search(r"^SERVING_INT8 weight-only per-output-channel$", out,
                     re.M), out
    assert "DECODE_DONE" in out and "serving=paged" in out
    assert re.search(r"K1Q_LAUNCHES paged_decode_attention_int8=0 "
                     r"kv_dtype=int8$", out, re.M), out


def test_worker_int8_speculation_serves_every_request():
    """The int8 pool and ring under speculation, with int8 weights:
    every request served to its budget, no kernel launched on the CPU."""
    args = worker.build_parser().parse_args(
        TINY + ["--device", "cpu", "--serve-fp32", "--kv-dtype", "int8",
                "--int8", "--speculate", "--spec-k", "2"])
    r = worker.run_decode(args)
    budgets = [max(8 * (1 + i % 4) // 4, 1) for i in range(4)]
    assert [len(r["outputs"][i]) for i in range(4)] == budgets
    assert r["kv_dtype"] == "int8" and r["spec_steps"] > 0
    assert r["k1_launches"] == r["k1q_launches"] == 0
    assert r["k2_launches"] == r["k2q_launches"] == 0
    # half the page bytes of the bf16 pool, plus the f32 scales
    full = worker.run_decode(worker.build_parser().parse_args(
        TINY + ["--device", "cpu"]))
    assert r["pool_bytes"] < full["pool_bytes"] * 3 // 4


def test_worker_serve_replays_waves(tmp_path):
    """``--serve`` prints the timed wave's lines, then one ``SERVING
    tokens_per_sec=`` line per replayed wave, until it is stopped."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
         "--model", "decode", "--serving", "paged", "--device", "cpu",
         "--serve", "--vocab", "61",
         "--layers", "1", "--heads", "2", "--hidden", "16", "--seq", "47",
         "--prompt-len", "12", "--page-size", "4", "--batch-per-chip", "2",
         "--steps", "4", "--serve-fp32"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            seen.append(line.split()[0])
            if seen.count("SERVING") >= 2:
                break
        assert "DECODE_DONE" in seen and seen.count("SERVING") >= 2, seen
        assert seen.index("DECODE_DONE") < seen.index("SERVING")
    finally:
        proc.kill()
        proc.communicate()


# tests/test_worker_modes.py's tiny decode geometry
MODES_TINY = ["--model", "decode", "--steps", "4", "--batch-per-chip", "2",
              "--vocab", "64", "--layers", "1", "--heads", "2", "--hidden",
              "16", "--seq", "16", "--prompt-len", "4", "--device", "cpu"]


def test_worker_serves_static_by_default(capsys):
    """tests/test_worker_modes.py:138: with no --serving the worker runs
    the aligned-batch static decode, as the JAX worker does, and prints
    its lines; the dense path launches no kernel of the port."""
    assert worker.build_parser().parse_args([]).serving == "static"
    assert worker.main(MODES_TINY) == 0
    out = capsys.readouterr().out
    assert re.search(r"^FIRST_DECODE_DONE seconds=[\d.]+$", out, re.M)
    assert re.search(r"^DECODE_DONE tokens_per_sec=[\d.]+ "
                     r"ms_per_call=[\d.]+$", out, re.M), out
    launches = re.search(r"^KERNEL_LAUNCHES (.*) serving=static "
                         r"device=cpu$", out, re.M)
    assert launches, out
    counts = dict(kv.split("=") for kv in launches.group(1).split())
    assert sorted(counts) == ["K1", "K1q", "K2", "K2q", "K3", "K4", "K5"]
    assert set(counts.values()) == {"0"}


def test_worker_static_serves_int8(capsys):
    """tests/test_worker_modes.py:149."""
    assert worker.main(MODES_TINY + ["--int8"]) == 0
    out = capsys.readouterr().out
    assert "SERVING_INT8" in out and "DECODE_DONE" in out


def test_worker_static_decodes_greedy_generate_of_the_jax_prompt():
    """The static batch is ``np.random.RandomState(1)``'s (batch,
    prompt_len) draw, decoded by ``greedy_generate`` over the served
    weights (int8 ones under --int8)."""
    import numpy as np
    import torch

    from kubegpu_tpu_torch.models.decoding import greedy_generate

    for extra in ([], ["--int8"]):
        args = worker.build_parser().parse_args(MODES_TINY + ["--serve-fp32"]
                                                + extra)
        r = worker.run_static(args)
        params, cfg, dtype = worker.serving_params(args, "cpu")
        prompt = np.random.RandomState(1).randint(0, 64, size=(2, 4))
        want = greedy_generate(params, torch.from_numpy(prompt).int(), 4,
                               **cfg, dtype=dtype, quant=bool(extra),
                               device="cpu")
        assert torch.equal(r["outputs"], want)
        assert r["tokens"] == 8 and r["ms_per_call"] > 0


@pytest.mark.parametrize("serving", ["continuous", "paged", "speculative"])
def test_worker_serves_batched_strategies(capsys, serving):
    """tests/test_worker_modes.py:170."""
    assert worker.main(MODES_TINY + ["--serving", serving]) == 0
    out = capsys.readouterr().out
    assert f"serving={serving}" in out and "DECODE_DONE" in out
    assert "admits=4" in out  # 2 slots x 2 = 4 requests through the wave


def test_worker_dense_waves_equal_the_paged_wave():
    """At fp32 the three batchers serve the worker's wave token for
    token, greedy and seed-pinned sampled; the dense modes launch no
    kernel of the port."""
    for extra in ([], ["--sample-temperature", "0.9", "--sample-top-k",
                       "5"]):
        outs = {}
        for serving in ("paged", "continuous", "speculative"):
            args = worker.build_parser().parse_args(
                TINY + ["--device", "cpu", "--serve-fp32", "--serving",
                        serving] + extra)
            r = worker.run_decode(args)
            outs[serving] = r["outputs"]
            assert set(r["launches"].values()) == {0}
            assert r["cache_bytes"] > 0
        assert outs["continuous"] == outs["paged"]
        if not extra:
            # sampled speculation is lossless in distribution only
            assert outs["speculative"] == outs["paged"]


@pytest.mark.parametrize("argv, match", [
    (["--serving", "continuous", "--kv-dtype", "int8"], "PAGED pool's knob"),
    (["--serving", "speculative", "--kv-dtype", "int8"], "PAGED pool's knob"),
    (["--serving", "static", "--kv-dtype", "int8"], "PAGED pool's knob"),
    (["--serving", "continuous", "--tp", "2"], "single-device"),
    (["--serving", "speculative", "--tp", "2"], "single-device"),
    (["--serving", "static", "--tp", "2"], "paged batcher's mesh"),
    (["--serving", "static", "--serve-http", "0"], "incremental serving"),
    (["--serving", "speculative", "--serve-http", "0"],
     "incremental serving"),
    (["--steps", "60"], "exceeds"),
], ids=["kv-continuous", "kv-speculative", "kv-static", "tp-continuous",
        "tp-speculative", "tp-static", "http-static", "http-speculative",
        "static-oversized"])
def test_worker_keeps_the_jax_workers_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        worker.main(MODES_TINY + argv)


# --tp N: N ranks serve one wave (rank 0 is the worker itself)
TP_WAVE = """
import json, sys
from kubegpu_tpu_torch.models import worker
r = worker.run_decode(worker.build_parser().parse_args(sys.argv[1:]))
print("WAVE " + json.dumps({"outputs": {str(k): v for k, v in
                                        r["outputs"].items()},
                            "tp": r["tp"], "steps": r["steps"],
                            "pool_bytes_per_device":
                            r["pool_bytes_per_device"],
                            "pool_bytes": r["pool_bytes"]}), flush=True)
"""


@pytest.mark.parametrize("extra", [
    [],
    ["--speculate", "--spec-k", "2", "--draft-hidden", "256",
     "--kv-dtype", "int8"],
], ids=["plain", "speculative-int8"])
def test_worker_tp2_on_cpu_serves_the_tp1_wave(extra):
    """``--tp 2 --device cpu``: two gloo ranks serve the wave the
    unsharded worker serves, token for token at fp32, each resting half
    the pool; the worker prints ``SERVING_TP tp=2`` and exits 0."""
    import json

    argv = TINY + ["--device", "cpu", "--serve-fp32"] + extra
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", TP_WAVE, *argv, "--tp", "2"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"^SERVING_TP tp=2 devices=cpu,cpu backend=gloo$",
                     proc.stdout, re.M), proc.stdout
    got = json.loads(re.search(r"^WAVE (.*)$", proc.stdout, re.M).group(1))
    ref = worker.run_decode(worker.build_parser().parse_args(argv))
    assert got["outputs"] == {str(k): v for k, v in ref["outputs"].items()}
    assert got["tp"] == 2 and got["steps"] == ref["steps"]
    assert got["pool_bytes"] == ref["pool_bytes"]
    assert got["pool_bytes_per_device"] * 2 == ref["pool_bytes"]


@pytest.mark.parametrize("argv, match", [
    (["--tp", "2"], "exceeds the visible device count"),
    (["--tp", "3", "--device", "cpu"], "--heads 4 not divisible by tp=3"),
    (["--tp", "2", "--vocab", "63", "--device", "cpu"],
     "--vocab 63 not divisible by tp=2"),
    (["--tp", "2", "--speculate", "--device", "cpu"],
     "draft head count 1"),
    (["--tp", "2", "--serving", "continuous", "--device", "cpu"],
     "single-device"),
], ids=["above-card-count", "heads", "vocab", "draft-heads", "dense"])
def test_worker_tp_refusals(argv, match):
    """The JAX worker's ``--tp`` refusals, before any rank starts: more
    ranks than visible cards (this machine has none), heads, vocab or
    draft heads that do not split, a dense batcher."""
    with pytest.raises(SystemExit, match=match):
        worker.main(TINY + argv)
