"""The MoE transformer on a card only (``-m cuda``; the tests skip
without a CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_moe.py -m cuda

- at float32 (TF32 off) with flash attention, one step's loss, aux and
  every gradient on the card equal the CPU's (rtol=atol 1e-4), each
  router with each dispatch, and K3, K4 and K5 launch once a layer;
- a dp 2 x ep 2 gloo gang on ``cuda:0`` equals the card's one device
  (1e-4);
- the worker's ``--model moe`` trains on the card: finite losses, the
  router's line, no flash kernel under its einsum attention."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import init_moe_params, tree_map
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_moe_cases as cases

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, hidden=64, max_seq=65,
           num_experts=4)
TOL = 1e-4
ROUTES = [dict(router_type="top1", dispatch_impl="einsum"),
          dict(router_type="top1", dispatch_impl="gather"),
          dict(router_type="top2", dispatch_impl="einsum"),
          dict(router_type="top2", dispatch_impl="gather"),
          dict(router_type="expert_choice")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path runs only "
                    "there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = old


def spec(route, device="cpu"):
    init = {k: v for k, v in CFG.items() if k != "num_heads"}
    params = init_moe_params(init, torch.Generator().manual_seed(4), "cpu")
    tokens = np.random.RandomState(5).randint(
        0, CFG["vocab_size"], size=(4, 65)).astype(np.int32)
    return dict(params=tree_map(lambda t: t.numpy(), params), cfg=CFG,
                model=dict(route, attn_impl="flash"), tokens=[tokens],
                device=device)


def assert_trees_close(got, want, tol):
    for k, w in want.items():
        if isinstance(w, dict):
            assert_trees_close(got[k], w, tol)
        else:
            np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("route", ROUTES,
                         ids=lambda r: "-".join(r.values()))
def test_card_equals_cpu_at_float32(cuda_device, route):
    cpu = cases.moe_grads(None, spec(route))
    card = cases.moe_grads(None, spec(route, cuda_device))
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(card["aux"], cpu["aux"], rtol=TOL, atol=TOL)
    assert card["drop"] == cpu["drop"]
    assert_trees_close(card["grads"], cpu["grads"], TOL)
    layers = CFG["num_layers"]
    assert card["launches"] == dict(flash_forward=layers,
                                    flash_backward_dkdv=layers,
                                    flash_backward_dq=layers,
                                    flash_backward_delta=0)
    assert not any(cpu["launches"].values())


def test_dp2_ep2_gang_on_the_card_equals_one_device(cuda_device, tmp_path):
    one = cases.moe_grads(None, spec(ROUTES[3], cuda_device))
    with Gang({"data": 2, "expert": 2}, str(tmp_path), backend="gloo",
              devices=["cuda:0"] * 4, timeout_s=600.0) as gang:
        got = gang.run(cases.moe_grads, spec(ROUTES[3]))
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], one["aux"], rtol=TOL, atol=TOL)
    assert_trees_close(got["grads"], one["grads"], TOL)


def test_worker_trains_moe_on_the_card(cuda_device, capsys):
    r = worker.run_moe(worker.build_parser().parse_args(
        ["--model", "moe", "--vocab", "128", "--hidden", "64", "--heads",
         "4", "--layers", "2", "--seq", "64", "--batch-per-chip", "4",
         "--steps", "3", "--num-experts", "4", "--moe-router", "top2",
         "--moe-dispatch", "gather"]))
    assert np.isfinite(r["losses"]).all() and r["step"] == 3
    assert r["device"].startswith("cuda") and r["peak_bytes"] > 0
    assert not any(r["launches"].values())
