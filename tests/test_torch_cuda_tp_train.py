"""Data x tensor-parallel LM training on a card only (``-m cuda``; the
tests skip without a CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_tp_train.py -m cuda

A gang of four gloo ranks, all on ``cuda:0`` (NCCL refuses two ranks on
one card), trains a small float32 model at dp 2 x tp 2 with sequence
parallelism (rank bodies in ``tests/torch_tp_cases.py``): one step's
loss and every gradient leaf, gathered whole, within rtol=atol 1e-4 of
the card's one-device step on the same global batch, with K3, K4 and K5
launched once a layer on every rank (two heads of 64 a rank; the float32
backward takes no delta pre-pass); then three steps' losses, weights and
momentum within 1e-4."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models.params import init_params, tree_map
from kubegpu_tpu_torch.models.train import (
    create_train_state,
    gather_state,
    grad_tree,
    lm_grads,
    lm_step,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_tp_cases as cases

AXES = {"data": 2, "model": 2}
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=256,
           max_seq=129)
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    return torch.device("cuda")


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _close(got, want):
    for k, w in want.items():
        if isinstance(w, dict):
            _close(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.cuda
def test_dp2_tp2_gang_on_one_card_equals_the_one_device_step(cuda_device,
                                                             tmp_path):
    params = _numpy(init_params(CFG, torch.Generator().manual_seed(6),
                                torch.float32, "cpu"))
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, CFG["vocab_size"], size=(4, 129))
               .astype(np.int32) for _ in range(3)]
    spec = dict(params=params, cfg=CFG, tokens=batches,
                model=dict(attn_impl="flash", sequence_parallel=True))

    def one_device():
        model = TransformerLM(dtype=torch.float32, attn_impl="flash", **CFG)
        return create_train_state(
            model, tree_map(lambda a: torch.from_numpy(a).to(cuda_device),
                            params))

    state = one_device()
    loss = lm_grads(state, torch.from_numpy(batches[0]).to(cuda_device))
    grads = _numpy(grad_tree(state))
    state = one_device()
    losses = [lm_step(state, torch.from_numpy(t).to(cuda_device)).item()
              for t in batches]
    whole, opt_state = gather_state(state)
    whole, moments = _numpy(whole), _numpy(opt_state["trace"])
    with Gang(AXES, str(tmp_path), backend="gloo", devices=["cuda:0"] * 4,
              timeout_s=600.0) as gang:
        got = gang.run(cases.train_grads, spec)
        steps = gang.run(cases.train_steps, spec)
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=TOL, atol=TOL)
    _close(got["grads"], grads)
    n = CFG["num_layers"]
    assert got["launches"] == dict(flash_forward=n, flash_backward_dkdv=n,
                                   flash_backward_dq=n,
                                   flash_backward_delta=0)
    np.testing.assert_allclose(steps["losses"], losses, rtol=TOL, atol=TOL)
    _close(steps["params"], whole)
    _close(steps["momentum"], moments)
