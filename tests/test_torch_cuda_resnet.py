"""ResNet data-parallel training on a card only (``-m cuda``; the tests
skip without a CUDA device).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_resnet.py -m cuda

- ``resnet-tiny`` at float32 (TF32 off): three carried SGD steps on the
  card equal the CPU's (losses rtol 1e-4, first-step gradients rtol=atol
  1e-4, its new ``batch_stats`` 1e-5), at 32 px and an odd 37 px;
- a two-rank gloo gang on ``cuda:0`` over ``{"data": 2}`` equals one
  device at the global batch (1e-4);
- the worker's ``--model resnet-tiny`` trains on the card: finite
  losses, both lines' numbers, no kernel of the port launched."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import init_resnet_params
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_resnet_cases as cases

pytestmark = pytest.mark.cuda

CFG = dict(layout="unrolled", stage_sizes=(1, 1, 1, 1), num_filters=8,
           num_classes=10, dtype="float32")
TOL = 1e-4
STATS_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path runs only "
                    "there")
    return "cuda"


def start(size, batch=8, seed=3):
    params, stats = init_resnet_params(cases.make_model(CFG),
                                       torch.Generator().manual_seed(seed),
                                       "cpu")
    rng = np.random.default_rng(size)
    return (cases.numpy_tree(params), cases.numpy_tree(stats),
            rng.standard_normal((3, batch, size, size, 3), dtype=np.float32),
            rng.integers(0, 10, (3, batch), dtype=np.int32))


def assert_trees_close(got, want, tol):
    for k, w in want.items():
        if isinstance(w, dict):
            assert_trees_close(got[k], w, tol)
        else:
            np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("size", [32, 37])
def test_card_equals_cpu_at_float32(cuda_device, size):
    args = start(size)
    cpu = cases.train(None, CFG, *args, device="cpu")
    card = cases.train(None, CFG, *args, device=cuda_device)
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=TOL)
    assert_trees_close(card["grads"], cpu["grads"], TOL)
    assert_trees_close(card["stats1"], cpu["stats1"], STATS_TOL)


def test_two_ranks_on_the_card_equal_one_device(cuda_device, tmp_path):
    args = start(32)
    one = cases.train(None, CFG, *args, device=cuda_device)
    with Gang({"data": 2}, str(tmp_path), backend="gloo",
              devices=["cuda:0"] * 2, timeout_s=600.0) as gang:
        two = gang.run(cases.train, CFG, *args)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=TOL,
                               atol=TOL)
    assert_trees_close(two["grads"], one["grads"], TOL)
    assert_trees_close(two["stats1"], one["stats1"], TOL)


def test_worker_trains_resnet_tiny_on_the_card(cuda_device):
    r = worker.run_resnet(worker.build_parser().parse_args(
        ["--model", "resnet-tiny", "--steps", "3"]))
    assert r["device"].startswith("cuda")
    assert all(np.isfinite(r["losses"])) and r["images_per_sec"] > 0
    assert set(r["launches"].values()) == {0}
    assert r["peak_bytes"] > 0
