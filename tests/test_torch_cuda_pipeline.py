"""The pipelined LM on a card only (``-m cuda``; the tests skip without a
CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_pipeline.py -m cuda

At float32 (TF32 off) on smoke phase 61's small pipeline (vocab 512,
hidden 64, 4 heads, 2 layers a stage, seq 64, 4 microbatches), three
carried non-Nesterov SGD steps: the card's one device against the CPU's,
and gloo gangs on ``cuda:0`` (GPipe and circular V 2 on ``{"pipe": 2}``,
PP x TP on ``{"pipe": 2, "model": 2}``) against the CPU's one device at
the same depth, within 1e-5 on every loss, every first-step gradient
leaf, the weights and the momentum; no kernel of the port launches."""

import math

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models.params import tree_map
from kubegpu_tpu_torch.models.pipeline_lm import init_pipeline_lm
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_pp_cases as cases

pytestmark = pytest.mark.cuda

TOL = 1e-5
WIDTHS = dict(vocab_size=512, hidden=64, num_heads=4, layers_per_stage=2,
              max_seq=65, num_microbatches=4)
BATCH, SEQ = 8, 64
RUNS = {"gpipe": ({"pipe": 2}, 1, None), "circular": ({"pipe": 2}, 2, None),
        "pp_tp": ({"pipe": 2, "model": 2}, 1, "model")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path runs only "
                    "there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = old


def whole(stages):
    widths = {k: v for k, v in WIDTHS.items()
              if k not in ("num_heads", "num_microbatches")}
    tree = init_pipeline_lm(torch.Generator().manual_seed(3),
                            num_stages=stages, device="cpu", **widths)
    return tree_map(lambda t: t.numpy(), tree)


def tokens():
    rs = np.random.RandomState(4)
    return [rs.randint(0, WIDTHS["vocab_size"], size=(BATCH, SEQ + 1))
            .astype(np.int32) for _ in range(3)]


def one_device(stages, device):
    """The stack as ``stages`` rounds over one stage."""
    tree = whole(stages)
    tree["blocks"] = {k: a.reshape((stages, 1) + a.shape[1:])
                      for k, a in tree["blocks"].items()}
    return cases.pp_steps(None, dict(
        params=tree, tokens=tokens(), device=device,
        cfg=dict(WIDTHS, num_stages=stages, num_rounds=stages)))


def assert_close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_close(got[k], want[k])
        return
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got).reshape(want.shape), want,
                               rtol=TOL, atol=TOL)


def test_card_equals_cpu_at_one_device(cuda_device):
    cpu = one_device(2, "cpu")
    card = one_device(2, cuda_device)
    for key in ("losses", "grads", "params", "trace"):
        assert_close(card[key], cpu[key])
    assert not any(card["launches"].values())


@pytest.mark.parametrize("name", list(RUNS))
def test_gang_on_the_card_equals_the_cpu(cuda_device, tmp_path, name):
    axes, rounds, model_axis = RUNS[name]
    p = axes["pipe"]
    tree = whole(p * rounds)
    if rounds > 1:
        tree["blocks"] = {k: a.reshape((rounds, p) + a.shape[1:])
                          for k, a in tree["blocks"].items()}
    with Gang(axes, str(tmp_path), backend="gloo",
              devices=["cuda:0"] * math.prod(axes.values()),
              timeout_s=600.0) as gang:
        got = gang.run(cases.pp_steps, dict(
            params=tree, tokens=tokens(),
            cfg=dict(WIDTHS, num_stages=p * rounds, num_rounds=rounds,
                     model_axis=model_axis)))
    want = one_device(p * rounds, "cpu")
    for key in ("losses", "grads", "params", "trace"):
        assert_close(got[key], want[key])
    assert got["step"] == 3 and not any(got["launches"].values())
