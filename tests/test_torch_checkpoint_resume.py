"""Resume against an uninterrupted run through the port's worker, on the
CPU at float32 weights: ``--model lm --steps 4`` and two runs of
``--steps 2`` on one ``--ckpt-dir`` (the second prints ``RESUMED
step=2``) end with the same checkpoint bit for bit (weights, optimizer
state, step) and the same losses, for SGD and for Adam, at one device
and over a dp 2 x tp 2 mesh of four gloo ranks (``--cpu-ranks 4 --tp
2``).  The resumed run reads the batches the uninterrupted run reads
from step 2 on."""

import numpy as np
import pytest

from kubegpu_tpu_torch.models import worker

TINY = ["--model", "lm", "--vocab", "64", "--hidden", "32", "--heads", "4",
        "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
        "--device", "cpu", "--ckpt-every", "100"]


def train(tmp, *extra):
    return worker.run_lm(worker.build_parser().parse_args(
        TINY + ["--ckpt-dir", str(tmp), *extra]))


def saved(tmp, step):
    with np.load(tmp / "lm" / str(step) / "state.npz") as z:
        return {k: z[k] for k in z.files}


def assert_same_checkpoint(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mesh", [
    [],
    ["--cpu-ranks", "4", "--tp", "2"],
], ids=["one-device", "dp2-tp2"])
@pytest.mark.parametrize("optimizer", [
    ["--optimizer", "sgd"],
    ["--optimizer", "adam"],
], ids=["sgd", "adam"])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, capsys, mesh,
                                                   optimizer):
    straight = train(tmp_path / "straight", "--steps", "4", *optimizer, *mesh)
    first = train(tmp_path / "resumed", "--steps", "2", *optimizer, *mesh)
    assert "RESUMED" not in capsys.readouterr().out
    second = train(tmp_path / "resumed", "--steps", "2", *optimizer, *mesh)
    out = capsys.readouterr().out
    assert "RESUMED step=2" in out and "CHECKPOINT_SAVED step=4" in out
    assert second["checkpoint"]["resumed_step"] == 2
    assert second["step"] == straight["step"] == 4
    assert first["losses"] + second["losses"] == straight["losses"]
    assert_same_checkpoint(saved(tmp_path / "resumed", 4),
                           saved(tmp_path / "straight", 4))
    if mesh:
        assert straight["mesh"] == {"data": 2, "model": 2}
