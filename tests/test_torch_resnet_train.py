"""The port's ResNet training (models/train.py ``resnet_step``,
``place_resnet``, ``parallel/collectives.py`` ``global_batch_norm``, the
worker's ResNet modes) against the JAX package at float32:

- three carried steps of nesterov SGD and of Adam from one state (JAX's
  perturbed init) on three batches give JAX's losses, first-step
  gradients, weights, optimizer state and ``batch_stats``;
- two gloo CPU ranks over ``{"data": 2}``, each on its half of every
  batch, give what JAX's ``{"data": 2}`` mesh gives (GSPMD reduces the
  BatchNorms over the global batch): the same losses, gradients,
  weights and statistics;
- the worker's ``--model resnet-tiny`` prints ``FIRST_STEP_DONE`` and
  ``steady_state images_per_sec=``, its first loss on JAX's weights
  within a bf16 tolerance of the JAX worker's on ``--data resident``,
  the same first loss over two ranks, and ``resnet50`` is the default
  ``--model``.

Each of the three steps starts from the port's state after the one
before, carried into JAX's step too, so each comparison is one step from
one state.  Tolerances, each against a leaf's own largest magnitude:
losses rtol 1e-5; ``batch_stats`` 1e-5; the first step's gradients 1e-4
(tests/test_torch_resnet.py's), later steps' ``CARRIED_GRAD_SHARE``;
optimizer state ``OPT_SHARE``; weights ``PARAM_SHARE``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import worker as jax_worker
from kubegpu_tpu.models.resnet import ResNet as JaxResNet
from kubegpu_tpu.models.train import (
    TrainState as JaxTrainState,
    make_resnet_train_step,
    place_resnet as jax_place_resnet,
    resnet_loss as jax_resnet_loss,
)
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.parallel.launch import Gang

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_resnet_cases as cases  # noqa: E402
from test_torch_resnet import (  # noqa: E402
    TINY,
    assert_tree_share,
    images_np,
    labels_np,
    perturbed_variables,
)

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the machine between several test processes), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = dict(TINY, layout="unrolled", dtype="float32")
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4
STATS_SHARE = 1e-5
# after a step the weights make BatchNorm scale gradients (sums of dy x
# xhat with much cancellation) round further from their largest term:
# measured 1.9e-4 at steps 2-3; the bound 2.5x that
CARRIED_GRAD_SHARE = 5e-4
# optax's nu is quadratic in the gradient: twice its relative error
OPT_SHARE = 2 * CARRIED_GRAD_SHARE
# an SGD step moves a weight by lr x (g + 0.9 t'), so its error is the
# gradient's times lr (measured 3.8e-5); an Adam step moves it by about
# lr x sign(g) where g is tiny, so a gradient at rounding level turns
# its rounding into the update: measured 1.05e-3, the bound 2.5x that
PARAM_SHARE = {"sgd": 1e-4, "adam": 2.5e-3}
STEPS = 3
BATCH = 4
# the worker's first loss in bf16 on JAX's fresh weights, against the
# JAX worker's: both round each conv and BatchNorm output to bf16 in
# other places; the bound is one bf16 step of the loss (2^-8 x 2.3),
# measured 1.5e-5 apart (the port's printed to 4 decimals)
BF16_FIRST_LOSS_TOL = 9e-3


def batches():
    return (np.stack([images_np(32, BATCH, seed=i) for i in range(STEPS)]),
            np.stack([labels_np(BATCH, seed=10 + i) for i in range(STEPS)]))


def jax_tx(optimizer):
    return (optax.sgd(0.1, momentum=0.9, nesterov=True)
            if optimizer == "sgd" else optax.adam(3e-4))


def jax_step(params, stats, opt_state, image, label, optimizer, mesh=None):
    """One ``make_resnet_train_step`` over ``mesh`` (one device when None)
    from the state ``params``, ``stats`` and ``opt_state`` (the port's,
    in optax's layout; None: optax's init), and that step's gradients."""
    model = JaxResNet(**TINY, dtype=jnp.float32)
    tx = jax_tx(optimizer)
    opt = tx.init(params)
    if opt_state is not None:
        opt = (opt[0]._replace(**{k: opt_state[k] for k in opt[0]._fields}),
               *opt[1:])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=opt,
                          apply_fn=model.apply, tx=tx)
    mesh = mesh or device_mesh({"data": 1}, devices=jax.devices()[:1])
    state, im, lb = jax_place_resnet(state, (image, label), mesh)
    grads, _ = jax.jit(jax.grad(lambda p, s, im, lb: jax_resnet_loss(
        state, p, s, im, lb), has_aux=True))(
            state.params, state.batch_stats, im, lb)
    state, loss = make_resnet_train_step(mesh, donate=False)(state, im, lb)
    return jax.tree.map(np.asarray, dict(
        loss=float(loss), grads=grads, params=state.params,
        stats=state.batch_stats, opt=state.opt_state[0]._asdict()))


def assert_step_matches_jax(got, want, optimizer, step):
    assert abs(got["losses"][0] - want["loss"]) <= LOSS_RTOL * want["loss"]
    assert_tree_share(got["grads"], want["grads"],
                      GRAD_SHARE if step == 0 else CARRIED_GRAD_SHARE,
                      "gradients")
    assert_tree_share(got["stats"], want["stats"], STATS_SHARE,
                      "batch_stats")
    assert_tree_share(got["params"], want["params"], PARAM_SHARE[optimizer],
                      "params")
    for name, tree in want["opt"].items():
        if name == "count":
            assert got["opt_state"]["count"] == int(tree) == step + 1
        else:
            assert_tree_share(got["opt_state"][name], tree, OPT_SHARE, name)


def carry_three_steps(start, optimizer, port_step, mesh=None):
    """Three steps, each from the port's state after the one before (its
    weights, statistics and optimizer state carried into JAX's step as
    well), so each comparison is one step from one state: two float32
    implementations, not their drift."""
    params, stats, images, labels = start
    opt_state = None
    for i in range(STEPS):
        want = jax_step(params, stats, opt_state, images[i], labels[i],
                        optimizer, mesh)
        got = port_step(params, stats, opt_state, images[i:i + 1],
                        labels[i:i + 1])
        assert_step_matches_jax(got, want, optimizer, i)
        params, stats, opt_state = (got["params"], got["stats"],
                                    got["opt_state"])


@pytest.fixture(scope="module")
def start():
    params, stats = perturbed_variables(JaxResNet(**TINY, dtype=jnp.float32),
                                        32)
    return params, stats, *batches()


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_three_carried_steps_match_make_resnet_train_step(start, optimizer):
    carry_three_steps(start, optimizer, lambda *a: cases.train(
        None, CFG, *a[:2], *a[3:], optimizer, opt_state=a[2]))


def test_two_ranks_match_the_jax_data2_mesh(start, tmp_path):
    """Every rank's BatchNorm reduces over both ranks' rows: without the
    backward's all-reduce the input gradients, and so every gradient
    below the head, are one rank's alone."""
    with Gang({"data": 2}, str(tmp_path), backend="gloo",
              devices=["cpu", "cpu"]) as gang:
        carry_three_steps(start, "sgd", lambda *a: gang.run(
            cases.train, CFG, *a[:2], *a[3:], "sgd", a[2]),
            mesh=device_mesh({"data": 2}, devices=jax.devices()[:2]))


RESIDENT = ["--model", "resnet-tiny", "--data", "resident", "--steps", "3"]


def test_worker_first_loss_on_jax_weights_is_the_jax_workers(monkeypatch,
                                                             capsys):
    """The port's worker on the JAX worker's fresh weights (recorded as
    the JAX worker builds them, handed to the port's init) and the
    resident batch (images of ones, labels 0; every row alike, so the
    loss does not depend on the JAX worker's 8 host devices) prints both
    lines, and its first loss is the JAX worker's within the bf16
    tolerance."""
    import kubegpu_tpu.models as jax_models
    from kubegpu_tpu_torch.models.params import params_from_numpy

    recorded = {}
    real_create = jax_models.create_train_state
    real_step = jax_models.make_resnet_train_step

    def create(model, rng, x, tx=None):
        state = real_create(model, rng, x, tx)
        recorded["params"] = jax.tree.map(np.asarray, state.params)
        recorded["stats"] = jax.tree.map(np.asarray, state.batch_stats)
        return state

    def make_step(mesh, donate=True):
        step = real_step(mesh, donate)

        def run(state, im, lb):
            state, loss = step(state, im, lb)
            recorded.setdefault("losses", []).append(float(loss))
            return state, loss
        return run

    monkeypatch.setattr(jax_models, "create_train_state", create)
    monkeypatch.setattr(jax_models, "make_resnet_train_step", make_step)
    assert jax_worker.main(RESIDENT[:-1] + ["1", "--batch-per-chip",
                                            "1"]) == 0
    monkeypatch.undo()
    capsys.readouterr()

    def jax_init(model, generator, device):
        return (params_from_numpy(recorded["params"], device),
                params_from_numpy(recorded["stats"], device))

    monkeypatch.setattr(worker, "init_resnet_params", jax_init)
    assert worker.main(RESIDENT + ["--device", "cpu",
                                   "--batch-per-chip", "2"]) == 0
    out = capsys.readouterr().out
    first = dict(f.split("=") for f in next(
        line for line in out.splitlines()
        if line.startswith("FIRST_STEP_DONE")).split()[1:])
    assert "steady_state images_per_sec=" in out
    assert "KERNEL_LAUNCHES K1=0 K1q=0 K2=0 K2q=0 K3=0 K4=0 K5=0" in out
    assert abs(float(first["loss"]) - recorded["losses"][0]) \
        <= BF16_FIRST_LOSS_TOL + 5e-5   # printed to 4 decimals


def test_worker_trains_over_two_cpu_ranks_as_one_device():
    """``--cpu-ranks 2``: a ``{"data": 2}`` mesh of two gloo processes,
    each on its half of the host batch; the first step sees the global
    batch one device sees, so its loss is one device's (bf16 convs over
    2 rows or 4 round alike on the CPU: measured equal)."""
    base = ["--model", "resnet-tiny", "--device", "cpu", "--steps", "2"]
    one = worker.run_resnet(worker.build_parser().parse_args(
        base + ["--batch-per-chip", "4"]))
    two = worker.run_resnet(worker.build_parser().parse_args(
        base + ["--batch-per-chip", "2", "--cpu-ranks", "2"]))
    assert two["mesh"] == {"data": 2}
    assert one["images_per_step"] == two["images_per_step"] == 4
    assert abs(two["losses"][0] - one["losses"][0]) <= 1e-5
    assert [r["launches"] for r in two["ranks"]] == [
        dict.fromkeys(one["launches"], 0)] * 2


def test_pool_and_stream_carry_the_same_image_batches():
    """``--data synthetic`` (a device pool) and ``--data stream``
    (prefetched copies) carry ``(images, labels)`` pairs of the worker's
    stream, the first set aside as the JAX worker's init batch, so both
    train step i on batch i: the same losses."""
    base = ["--model", "resnet-tiny", "--device", "cpu", "--steps", "2",
            "--batch-per-chip", "2"]
    pool, stream = (worker.run_resnet(worker.build_parser().parse_args(
        base + ["--data", mode])) for mode in ("synthetic", "stream"))
    assert pool["losses"] == stream["losses"]


def test_resnet50_is_the_default_model():
    args = worker.build_parser().parse_args([])
    assert (args.model, args.image_size, args.num_classes,
            args.batch_per_chip) == ("resnet50", 224, 1000, 32)
    model = worker.resnet_model(args)
    assert model.layout == "scan" and model.stage_sizes == (3, 4, 6, 3)
    tiny = worker.resnet_model(worker.build_parser().parse_args(
        ["--model", "resnet-tiny", "--image-size", "64",
         "--num-classes", "100"]))
    assert (tiny.image_size, tiny.num_classes) == (32, 10)


@pytest.mark.parametrize("argv", [
    # the default model, as samples/jax-resnet.yaml runs it, at a size
    # that stays cheap if the refusal ever goes missing
    ["--steps", "1", "--batch-per-chip", "1", "--image-size", "32"],
    ["--model", "resnet-tiny", "--cpu-ranks", "2", "--steps", "1"],
    ["--model", "lm", "--steps", "1"],
], ids=["resnet50", "resnet-tiny-dp2", "lm"])
def test_training_refuses_a_gang_of_pods(monkeypatch, argv):
    """A training pod joins its gang from the shim's env (tests/
    test_torch_gang.py), but refuses a table it cannot join, where the
    JAX worker's rendezvous fails too: a ``JAX_NUM_PROCESSES`` that is
    not a count, and a count above 1 with no coordinator to meet at."""
    monkeypatch.setenv("JAX_NUM_PROCESSES", "four")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:8476")
    with pytest.raises(SystemExit, match="JAX_NUM_PROCESSES='four' is not "
                       "a count"):
        worker.main(argv + ["--device", "cpu"])
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    with pytest.raises(SystemExit, match="JAX_NUM_PROCESSES=4 with no "
                       "JAX_COORDINATOR_ADDRESS"):
        worker.main(argv + ["--device", "cpu"])
