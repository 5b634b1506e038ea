"""Checkpoints on a card only (``-m cuda``; the tests skip without a CUDA
device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_checkpoint.py -m cuda

- a small float32 model trained on the card with the flash kernels
  (K3, K4, K5), SGD and Adam: "train 2, save, restore into fresh
  weights, train 2" equals "train 4" (the kernels are deterministic, so
  bit for bit is expected; the gate is 1e-6), every restored leaf on the
  card;
- a dp 2 x tp 2 gang of four gloo ranks on ``cuda:0`` saves the same way
  and restores onto one device: every leaf bit for bit what was saved;
- the worker: ``--model lm --ckpt-dir`` resumed equals uninterrupted,
  and ``--model decode --ckpt-dir`` serves the bf16 cast of what was
  saved, with K1 launched."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.checkpoint import (
    make_manager,
    restore_checkpoint,
    save_checkpoint,
)
from kubegpu_tpu_torch.models.params import init_params, tree_map
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    gather_state,
    lm_step,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.ops.paged_attention import paged_decode_attention
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_tp_cases as cases

CFG = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=256,
           max_seq=129)
RESUME_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    return torch.device("cuda")


def init(seed):
    """Float32 weights drawn on the CPU from ``seed``."""
    return init_params({k: v for k, v in CFG.items() if k != "num_heads"},
                       torch.Generator().manual_seed(seed), torch.float32,
                       "cpu")


def batches(n):
    rng = np.random.RandomState(1)
    return [rng.randint(0, CFG["vocab_size"], size=(4, 129)).astype(np.int32)
            for _ in range(n)]


def card_state(seed, optimizer, device):
    model = TransformerLM(dtype=torch.float32, attn_impl="flash", **CFG)
    return create_train_state(
        model, tree_map(lambda t: t.to(device), init(seed)),
        optimizer=optimizer)


def flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, v


def max_diff(a, b) -> float:
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    return max(float((fa[k].double().cpu() - fb[k].double().cpu()).abs()
                     .max()) for k in fa)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", [sgd(), adam(lr=1e-3)],
                         ids=["sgd", "adam"])
def test_resume_on_the_card_equals_the_uninterrupted_run(cuda_device,
                                                         tmp_path,
                                                         optimizer):
    data = [torch.from_numpy(t).to(cuda_device) for t in batches(4)]
    straight = card_state(0, optimizer, cuda_device)
    want = [lm_step(straight, t).item() for t in data]
    state = card_state(0, optimizer, cuda_device)
    got = [lm_step(state, t).item() for t in data[:2]]
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state)
    fresh = card_state(1, optimizer, cuda_device)
    restore_checkpoint(mgr, fresh)
    assert fresh.step == 2
    for _, t in flat(gather_state(fresh)[1]):
        if t.ndim:
            assert t.device.type == "cuda"
    got += [lm_step(fresh, t).item() for t in data[2:]]
    np.testing.assert_allclose(got, want, rtol=RESUME_TOL, atol=RESUME_TOL)
    wp, wo = gather_state(straight)
    gp, go = gather_state(fresh)
    assert max_diff(gp, wp) <= RESUME_TOL
    assert max_diff(go, wo) <= RESUME_TOL


@pytest.mark.cuda
def test_a_gang_checkpoint_restores_on_one_card(cuda_device, tmp_path):
    params = cases._np(init(0))
    d = str(tmp_path / "ckpt")
    with Gang({"data": 2, "model": 2}, str(tmp_path), backend="gloo",
              devices=["cuda:0"] * 4, timeout_s=600.0) as gang:
        got = gang.run(cases.train_save_resume, dict(
            params=params, fresh=cases._np(init(1)), cfg=CFG,
            model=dict(attn_impl="flash", sequence_parallel=True),
            tokens=batches(4), save_after=2, dir=d))
    assert got["resumed"]["losses"] == pytest.approx(
        got["straight"]["losses"], rel=RESUME_TOL, abs=RESUME_TOL)
    state = card_state(2, sgd(), cuda_device)
    restore_checkpoint(make_manager(d), state)
    whole, opt = gather_state(state)
    with np.load(f"{d}/2/state.npz") as z:
        for path, t in flat(whole):
            assert np.array_equal(t.cpu().numpy(), z[f"params/{path}"]), path
        for path, t in flat(opt):
            assert np.array_equal(t.cpu().numpy(),
                                  z[f"opt_state/{path}"]), path


@pytest.mark.cuda
def test_the_worker_resumes_and_serves_on_the_card(cuda_device, tmp_path,
                                                   capsys):
    lm = ["--model", "lm", "--vocab", "256", "--hidden", "256", "--heads",
          "4", "--layers", "2", "--seq", "128", "--batch-per-chip", "2"]
    runs = {}
    for name, steps in (("straight", [4]), ("resumed", [2, 2])):
        losses = []
        for n in steps:
            r = worker.run_lm(worker.build_parser().parse_args(
                lm + ["--steps", str(n), "--ckpt-dir",
                      str(tmp_path / name)]))
            losses += r["losses"]
            assert r["k3_launches"] == n * 2
        runs[name] = losses
    assert "RESUMED step=2" in capsys.readouterr().out
    np.testing.assert_allclose(runs["resumed"], runs["straight"],
                               rtol=RESUME_TOL, atol=RESUME_TOL)
    args = worker.build_parser().parse_args(
        ["--model", "decode", "--serving", "paged", "--vocab", "256",
         "--hidden", "256", "--heads", "4", "--layers", "2", "--seq", "128",
         "--prompt-len", "32", "--batch-per-chip", "2", "--steps", "8",
         "--ckpt-dir", str(tmp_path / "resumed")])
    params, _, _ = worker.serving_params(args, "cuda")
    assert "RESTORED_FOR_SERVING step=4" in capsys.readouterr().out
    with np.load(tmp_path / "resumed" / "lm" / "4" / "state.npz") as z:
        for path, t in flat(params):
            want = torch.from_numpy(z[f"params/{path}"]).to(torch.bfloat16)
            assert torch.equal(t.cpu(), want), path
    paged_decode_attention.launches = 0
    r = worker.run_decode(args)
    assert r["k1_launches"] == r["decode_steps_total"] * 2 > 0
