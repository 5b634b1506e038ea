"""Trained weights cross from the JAX package to the port: the JAX worker
trains a tiny LM (``--model lm --tp 4 --ckpt-dir``, Orbax, on the
8-device CPU mesh) and a tiny draft, ``tools/orbax_to_torch_checkpoint.py``
converts both, and the port's worker serves them as the JAX worker serves
the Orbax originals, token for token at float32:

- ``--model decode --serve-fp32 --ckpt-dir`` (static): the JAX worker's
  own greedy call, recorded as it runs, against the port's
  ``greedy_generate`` over the port worker's restored weights on the same
  prompt;
- ``--serving paged``: both workers' timed waves (the same requests);
- ``--serving paged --speculate --draft-ckpt-dir``: the same, and the
  same verify count and accepted tokens (both drafts are the bf16 cast
  of the one trained draft).

The port's worker resumes the converted training checkpoint
(``RESUMED step=3``) and refuses the Orbax directory itself, naming the
converter.  Both workers print ``RESTORED_FOR_SERVING step=3`` and
``RESTORED_DRAFT_FOR_SERVING``."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import worker as jax_worker
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.decoding import greedy_generate

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import orbax_to_torch_checkpoint as converter  # noqa: E402

WIDTHS = ["--vocab", "64", "--hidden", "32", "--heads", "4", "--layers", "2",
          "--seq", "32"]
DRAFT = ["--vocab", "64", "--hidden", "32", "--heads", "1", "--layers", "1",
         "--seq", "32"]
TRAIN = ["--model", "lm", "--steps", "3", "--batch-per-chip", "1",
         "--data-pool", "2"]
DECODE = ["--model", "decode", "--serve-fp32", "--prompt-len", "8",
          "--batch-per-chip", "2", "--steps", "8"] + WIDTHS
SPEC = ["--serving", "paged", "--speculate", "--spec-k", "2",
        "--draft-hidden", "32"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The JAX worker's Orbax checkpoints of a target and a draft, and
    their conversions."""
    root = tmp_path_factory.mktemp("jax-ckpt")
    dirs = {k: str(root / k) for k in ("jax", "jax_draft", "port",
                                       "port_draft")}
    assert jax_worker.main(TRAIN + WIDTHS + ["--tp", "4", "--ckpt-dir",
                                             dirs["jax"]]) == 0
    assert jax_worker.main(TRAIN + DRAFT + ["--tp", "1", "--ckpt-dir",
                                            dirs["jax_draft"]]) == 0
    for src, dst in (("jax", "port"), ("jax_draft", "port_draft")):
        out = converter.convert(dirs[src], dirs[dst])
        assert out == os.path.join(dirs[dst], "lm", "3")
    return dirs


def test_the_converter_writes_the_ports_format(ckpts):
    from kubegpu_tpu_torch.models.checkpoint import make_manager

    mgr = make_manager(os.path.join(ckpts["port"], "lm"))
    assert mgr.all_steps() == [3]
    meta = mgr.read_meta(3)
    assert meta["optimizer"] == dict(name="sgd", lr=None)
    assert meta["model"] == dict(vocab_size=64, hidden=32, max_seq=33,
                                 num_layers=2, num_heads=None)
    with mgr.open(3) as ckpt:
        assert int(ckpt.leaf("step")) == 3
        assert any(k.startswith("opt_state/trace/") for k in ckpt.keys)


def test_the_port_refuses_the_orbax_original(ckpts):
    args = worker.build_parser().parse_args(
        DECODE + ["--device", "cpu", "--ckpt-dir", ckpts["jax"]])
    with pytest.raises(ValueError, match="orbax_to_torch_checkpoint"):
        worker.serving_params(args, "cpu")


def test_the_port_resumes_the_converted_training_state(ckpts, capsys,
                                                       tmp_path):
    import shutil

    d = tmp_path / "resume"
    shutil.copytree(ckpts["port"], d)
    assert worker.main(TRAIN[:2] + ["--steps", "1", "--batch-per-chip", "2",
                                    "--device", "cpu", "--ckpt-dir", str(d)]
                       + WIDTHS) == 0
    out = capsys.readouterr().out
    assert "RESUMED step=3" in out and "CHECKPOINT_SAVED step=4" in out


def test_static_stream_equals_the_jax_workers(ckpts, capsys, monkeypatch):
    calls = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **kw):
        compiled = real_jit(fn, *a, **kw)

        def call(*args):
            out = compiled(*args)
            calls.append((args, out))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    assert jax_worker.main(DECODE + ["--ckpt-dir", ckpts["jax"]]) == 0
    monkeypatch.undo()
    assert "RESTORED_FOR_SERVING step=3" in capsys.readouterr().out
    (_, prompt), want = calls[-1]
    assert prompt.shape == (2, 8)

    assert worker.main(DECODE + ["--device", "cpu",
                                 "--ckpt-dir", ckpts["port"]]) == 0
    assert "RESTORED_FOR_SERVING step=3" in capsys.readouterr().out
    args = worker.build_parser().parse_args(
        DECODE + ["--device", "cpu", "--ckpt-dir", ckpts["port"]])
    params, cfg, dtype = worker.serving_params(args, "cpu", announce=False)
    got = greedy_generate(params, torch.from_numpy(np.array(prompt)), 8,
                          **cfg, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jax_waves(monkeypatch, argv):
    """The JAX worker's waves: (prompts, outputs, stats) of each."""
    waves = []
    real_run = JaxPagedContinuousBatcher.run

    def run(self, prompts, budgets, **kw):
        out = real_run(self, prompts, budgets, **kw)
        waves.append(([np.asarray(p) for p in prompts], out,
                      dict(self.stats)))
        return out

    monkeypatch.setattr(JaxPagedContinuousBatcher, "run", run)
    assert jax_worker.main(argv) == 0
    monkeypatch.undo()
    return waves


@pytest.mark.parametrize("speculate", [False, True], ids=["plain", "spec"])
def test_paged_stream_equals_the_jax_workers(ckpts, capsys, monkeypatch,
                                             speculate):
    extra = SPEC if speculate else ["--serving", "paged"]
    jax_argv = DECODE + extra + ["--ckpt-dir", ckpts["jax"]]
    port_argv = DECODE + extra + ["--device", "cpu",
                                  "--ckpt-dir", ckpts["port"]]
    if speculate:
        jax_argv += ["--draft-ckpt-dir", ckpts["jax_draft"]]
        port_argv += ["--draft-ckpt-dir", ckpts["port_draft"]]
    waves = jax_waves(monkeypatch, jax_argv)
    jax_out = capsys.readouterr().out
    r = worker.run_decode(worker.build_parser().parse_args(port_argv))
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert "RESTORED_FOR_SERVING step=3" in out
        assert ("RESTORED_DRAFT_FOR_SERVING" in out) == speculate
    assert len(waves) == 2   # the warm-up wave, then the timed one
    _, want, stats = waves[-1]
    assert r["outputs"] == want
    assert r["steps"] == stats["steps"]
    if speculate:
        assert r["spec_steps"] == stats["spec_steps"] > 0
        assert r["spec_tokens"] == stats["spec_tokens"]
