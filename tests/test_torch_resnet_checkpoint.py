"""Checkpoints of the port's ResNet training (``--model resnet-tiny
--ckpt-dir``, models/checkpoint.py) on the CPU:

- a resumed run equals the uninterrupted one bit for bit, at one device
  and over a ``{"data": 2}`` mesh of two gloo ranks: the weights, the
  momentum and the BatchNorm statistics, which the step's npz holds
  under ``batch_stats/`` beside the ResNet's dims in its record;
- a checkpoint written by two ranks restores at one, leaf for leaf, and
  the resumed step's loss is the two-rank run's at that step;
- the JAX worker's Orbax checkpoint of ``--model resnet-tiny``, converted
  by ``tools/orbax_to_torch_checkpoint.py``, resumes in the port's worker
  to the JAX worker's next loss at float32 (both workers' ResNets built
  at float32 for the test; ``--data resident``, the batch the JAX
  worker's restarted stream and the port's skipping one agree on)."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.checkpoint import make_manager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import orbax_to_torch_checkpoint as converter  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the machine between several test processes), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = ["--model", "resnet-tiny", "--device", "cpu", "--batch-per-chip",
        "2"]
# the resumed step at one device against the same step over two ranks
# (bf16 convs over 4 rows or 2 on the CPU): measured equal
DP_LOSS_TOL = 1e-5
FP32_LOSS_TOL = 1e-5


def run(argv):
    return worker.run_resnet(worker.build_parser().parse_args(TINY + argv))


def npz(root, step):
    with np.load(os.path.join(root, "resnet-tiny", str(step),
                              "state.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("ranks", ["1", "2"])
def test_resumed_equals_uninterrupted_bit_for_bit(tmp_path, capsys, ranks):
    resumed, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    mesh = ["--cpu-ranks", ranks]
    run(mesh + ["--steps", "2", "--ckpt-dir", resumed])
    r = run(mesh + ["--steps", "2", "--ckpt-dir", resumed])
    assert r["checkpoint"]["resumed_step"] == 2 and r["step"] == 4
    full = run(mesh + ["--steps", "4", "--ckpt-dir", whole])
    assert full["losses"][2:] == r["losses"]
    got, want = npz(resumed, 4), npz(whole, 4)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "batch_stats/bn_init/mean" in got
    assert "batch_stats/stage4_block1/bn_proj/var" in got
    assert any(k.startswith("opt_state/trace/") for k in got)
    meta = make_manager(os.path.join(resumed, "resnet-tiny")).read_meta(4)
    assert meta["model"] == dict(family="resnet", layout="unrolled",
                                 stage_sizes=[1, 1, 1, 1], num_filters=8,
                                 num_classes=10, image_size=32)
    assert sorted(meta["batch_stats"]) == sorted(
        k for k in got if k.startswith("batch_stats/"))
    out = capsys.readouterr().out
    assert "RESUMED step=2" in out and "CHECKPOINT_SAVED step=4" in out


def test_a_two_rank_checkpoint_restores_at_one_rank(tmp_path):
    from kubegpu_tpu_torch.models.checkpoint import restore_checkpoint

    two = str(tmp_path / "two")
    run(["--cpu-ranks", "2", "--steps", "2", "--ckpt-dir", two])
    whole = run(["--cpu-ranks", "2", "--steps", "3", "--ckpt-dir",
                 str(tmp_path / "whole")])
    args = worker.build_parser().parse_args(TINY + ["--batch-per-chip", "4"])
    state, _ = worker.build_resnet_trainer(args)
    restore_checkpoint(make_manager(os.path.join(two, "resnet-tiny")), state)
    saved = npz(two, 2)
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), torch.from_numpy(
            saved["params/" + name.replace(".", "/")])), name
    for name, b in state.model.named_buffers():
        assert torch.equal(b, torch.from_numpy(
            saved["batch_stats/" + name.replace(".", "/")])), name
    one = run(["--batch-per-chip", "4", "--steps", "1", "--ckpt-dir", two])
    assert one["checkpoint"]["resumed_step"] == 2 and one["step"] == 3
    assert abs(one["losses"][0] - whole["losses"][2]) <= DP_LOSS_TOL


RESIDENT = ["--model", "resnet-tiny", "--data", "resident"]


def test_a_converted_jax_checkpoint_resumes_to_the_jax_workers_next_loss(
        tmp_path, monkeypatch, capsys):
    import kubegpu_tpu.models as jax_models
    from kubegpu_tpu.models import worker as jax_worker

    losses = []
    real_step = jax_models.make_resnet_train_step

    def make_step(mesh, donate=True):
        step = real_step(mesh, donate)

        def run_step(state, im, lb):
            state, loss = step(state, im, lb)
            losses.append(float(loss))
            return state, loss
        return run_step

    monkeypatch.setattr(jax_models, "ResNet", partial(
        jax_models.ResNet, dtype=jnp.float32))
    monkeypatch.setattr(jax_models, "make_resnet_train_step", make_step)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n = jax.device_count()
    argv = RESIDENT + ["--batch-per-chip", "1", "--ckpt-dir", jax_dir]
    assert jax_worker.main(argv + ["--steps", "2"]) == 0
    out = converter.convert(jax_dir, port_dir, "resnet-tiny")
    assert out == os.path.join(port_dir, "resnet-tiny", "2")
    assert jax_worker.main(argv + ["--steps", "1"]) == 0   # resumes: step 3
    monkeypatch.undo()
    assert "RESUMED step=2" in capsys.readouterr().out
    meta = make_manager(os.path.dirname(out)).read_meta(2)
    assert meta["model"] == dict(family="resnet", layout="unrolled",
                                 stage_sizes=[1, 1, 1, 1], num_filters=8,
                                 num_classes=10, image_size=None)
    assert "batch_stats/bn_init/var" in meta["batch_stats"]
    monkeypatch.setattr(worker, "RESNET_DTYPE", torch.float32)
    r = worker.run_resnet(worker.build_parser().parse_args(
        RESIDENT + ["--device", "cpu", "--batch-per-chip", str(n),
                    "--steps", "1", "--ckpt-dir", port_dir]))
    assert r["checkpoint"]["resumed_step"] == 2
    assert len(losses) == 3   # two steps, then the resumed third
    assert abs(r["losses"][0] - losses[-1]) <= FP32_LOSS_TOL * losses[-1]
