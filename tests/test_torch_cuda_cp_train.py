"""Context-parallel attention and training on a card only (``-m cuda``;
the tests skip without a CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_cp_train.py -m cuda

- A ring block through the kernels: K3 unmasked (a block owned by an
  earlier rank) and causal (the diagonal) on one 512-row block, the
  two folded into one global (out, lse) as the ring folds them, then K4
  and K5 on each block from that global lse (which neither block's K3
  computed), at float32 against the plain twins on the same operands
  (out and lse 2e-5, gradients 1e-4).
- Ring and Ulysses attention in a gang of two gloo ranks, both on
  ``cuda:0`` (NCCL refuses two ranks on one card), against the float32
  reference attention over the whole sequence, with the launches of
  each rank: ring K3, K4 and K5 ``r + 1`` times at coordinate r,
  Ulysses once; every hop staged through the host.
- The same gang at dp 1 x cp 2 trains a small float32 model (rank
  bodies in ``tests/torch_cp_cases.py``): one step's loss and every
  gradient within rtol=atol 1e-4 of the card's one-device flash step on
  the same batch, for ring and Ulysses, then three steps' losses,
  weights and momentum within 1e-4."""

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
from kubegpu_tpu_torch.ops.attention import (
    _fold,
    flash_backward_dkdv,
    flash_backward_dkdv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward,
    flash_forward_plain,
    reference_attention,
)
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_cp_cases as cases

AXES = {"data": 1, "seq": 2}
CFG = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=256,
           max_seq=257)
SEQ = 256
TOL = 1e-4
F32_TOL = 2e-5


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
def test_ring_blocks_through_the_kernels_match_the_twins(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shape = (2, 512, 4, 64)
    q, k0, v0, k1, v1, dout = (torch.randn(shape, generator=g,
                                           device=cuda_device)
                               for _ in range(6))
    # the block of an earlier rank (unmasked), then the diagonal
    blocks = ((k0, v0, False), (k1, v1, True))
    o = torch.zeros(shape, device=cuda_device)
    lse = torch.full((2, 4, 512), float("-inf"), device=cuda_device)
    for k, v, causal in blocks:
        got, got_lse = flash_forward(q, k, v, causal)
        want, want_lse = flash_forward_plain(q, k, v, causal)
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(got_lse, want_lse, rtol=F32_TOL,
                                   atol=F32_TOL)
        o, lse = _fold(o, lse, got, got_lse)
    for k, v, causal in blocks:
        dk, dv = flash_backward_dkdv(q, k, v, o, lse, dout, causal)
        dq = flash_backward_dq(q, k, v, o, lse, dout, causal)
        want_dk, want_dv = flash_backward_dkdv_plain(q, k, v, o, lse, dout,
                                                     causal)
        want_dq = flash_backward_dq_plain(q, k, v, o, lse, dout, causal)
        for a, b in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_cp_attention_on_one_card_matches_the_reference(cuda_device,
                                                        tmp_path, impl):
    rng = np.random.RandomState(0)
    x = {n: rng.randn(2, 2 * 256, 4, 64).astype(np.float32)
         for n in ("q", "k", "v", "dout")}
    with Gang(AXES, str(tmp_path), backend="gloo", devices=["cuda:0"] * 2,
              timeout_s=600.0) as gang:
        got = gang.run(cases.attention, dict(x, impl=impl, causal=True))
    q, k, v = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    out = reference_attention(q, k, v, True)
    out.backward(torch.from_numpy(x["dout"]))
    np.testing.assert_allclose(got["out"], out.detach().numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        np.testing.assert_allclose(got[n], t.grad.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=n)
    for r, launches in enumerate(got["launches"]):
        n = r + 1 if impl == "ring" else 1
        assert launches == dict(flash_forward=n, flash_backward_dkdv=n,
                                flash_backward_dq=n,
                                flash_backward_delta=0), (r, launches)
    assert all(t["host_staged"] > 0 for t in got["traffic"])


@pytest.mark.cuda
def test_cp2_gang_on_one_card_equals_the_one_device_step(cuda_device,
                                                         tmp_path):
    params = _numpy(init_params(CFG, torch.Generator().manual_seed(6),
                                torch.float32, "cpu"))
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, CFG["vocab_size"], size=(2, SEQ + 1))
               .astype(np.int32) for _ in range(3)]

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
    layers = CFG["num_layers"]
    with Gang(AXES, str(tmp_path), backend="gloo", devices=["cuda:0"] * 2,
              timeout_s=600.0) as gang:
        for impl in ("ring", "ulysses"):
            spec = dict(params=params, cfg=CFG, tokens=batches,
                        model=dict(attn_impl=impl))
            got = gang.run(cases.cp_grads, spec)
            np.testing.assert_allclose(got["loss"], loss.item(), rtol=TOL,
                                       atol=TOL)
            _close(got["grads"], grads)
            for r, launches in enumerate(got["launches"]):
                n = layers * (r + 1 if impl == "ring" else 1)
                assert launches == dict(
                    flash_forward=n, flash_backward_dkdv=n,
                    flash_backward_dq=n, flash_backward_delta=0), (
                        impl, r, launches)
        steps = gang.run(cases.cp_steps, dict(
            params=params, cfg=CFG, tokens=batches,
            model=dict(attn_impl="ring")))
    np.testing.assert_allclose(steps["losses"], losses, rtol=TOL, atol=TOL)
    _close(steps["params"], whole)
    _close(steps["opt_state"]["trace"], moments)
