"""The port's checkpoints (kubegpu_tpu_torch/models/checkpoint.py) and the
worker's checkpoint flags, on the CPU at a tiny width, without JAX: a
save restores bit for bit into a fresh state (SGD and Adam), an empty
directory restores None, retention keeps the last three steps, a stray
temporary directory is never a step, an Orbax step raises naming the
converter, a shape, depth or optimizer that does not match raises naming
what differs, and a step saved twice is replaced.  The worker prints
``RESUMED``, ``CHECKPOINT_SAVED``, ``RESTORED_FOR_SERVING`` and
``RESTORED_DRAFT_FOR_SERVING`` as the JAX worker does, warns of legacy
step directories and of a missing checkpoint, and serves the restored
weights (bf16 a cast of the saved float32, or float32 as saved)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.checkpoint import (
    CONVERTER,
    make_manager,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from kubegpu_tpu_torch.models.params import init_params
from kubegpu_tpu_torch.models.serving import load_draft_checkpoint
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    gather_state,
    lm_step,
    opt_state_tree,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM

CFG = dict(vocab_size=64, num_layers=2, hidden=32, max_seq=17)
HEADS = 4
TINY_LM = ["--model", "lm", "--vocab", "64", "--hidden", "32", "--heads",
           "4", "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
           "--device", "cpu"]
TINY_DECODE = ["--model", "decode", "--vocab", "64", "--hidden", "32",
               "--heads", "4", "--layers", "2", "--seq", "16",
               "--prompt-len", "8", "--batch-per-chip", "2", "--steps", "4",
               "--device", "cpu"]


def state_of(seed, optimizer=None, cfg=CFG):
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         torch.float32, "cpu")
    return create_train_state(
        TransformerLM(num_heads=HEADS, dtype=torch.float32, **cfg), params,
        optimizer=optimizer)


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, CFG["vocab_size"], size=(2, 17))
                             .astype(np.int32)) for _ in range(n)]


def flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, v


def assert_trees_equal(a, b):
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("optimizer", [sgd(), adam(lr=1e-2)],
                         ids=["sgd", "adam"])
def test_round_trip_restores_params_optimizer_state_and_step(tmp_path,
                                                             optimizer):
    state = state_of(0, optimizer)
    for tokens in batches(3):
        lm_step(state, tokens)
    mgr = make_manager(str(tmp_path))
    assert save_checkpoint(mgr, state) == 3
    assert mgr.latest_step() == 3
    fresh = state_of(1, optimizer)
    assert restore_checkpoint(make_manager(str(tmp_path)), fresh) is fresh
    assert fresh.step == 3
    want_p, want_o = gather_state(state)
    got_p, got_o = gather_state(fresh)
    assert_trees_equal(got_p, want_p)
    assert_trees_equal(got_o, want_o)
    if optimizer.name == "adam":
        assert int(opt_state_tree(fresh)["count"]) == 3
    # the restored parameters are the model's own: training goes on
    # from them exactly as it goes on from the saved state
    more = batches(2, seed=5)
    assert [lm_step(state, t).item() for t in more] == [
        lm_step(fresh, t).item() for t in more]
    assert_trees_equal(gather_state(fresh)[0], gather_state(state)[0])


def test_empty_directory_restores_none(tmp_path):
    mgr = make_manager(str(tmp_path / "none"))
    assert mgr.latest_step() is None
    assert restore_checkpoint(mgr, state_of(0)) is None
    assert restore_params(mgr, dict(CFG, num_heads=HEADS),
                          device="cpu") is None


def test_retention_keeps_the_last_three_steps(tmp_path):
    state = state_of(0)
    mgr = make_manager(str(tmp_path))
    for step in range(1, 6):
        state.step = step
        save_checkpoint(mgr, state)
    assert mgr.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]


def test_a_stray_temporary_directory_is_not_a_step(tmp_path):
    state = state_of(0)
    state.step = 2
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state)
    # a save cut short: its temporary directory holds a partial file
    stray = tmp_path / ".tmp-7-deadbeef"
    stray.mkdir()
    (stray / "state.npz").write_bytes(b"PK\x03\x04 half")
    assert mgr.latest_step() == 2
    fresh = state_of(1)
    restore_checkpoint(mgr, fresh)
    assert fresh.step == 2


def test_an_orbax_step_raises_naming_the_converter(tmp_path):
    step = tmp_path / "lm" / "3"
    (step / "default").mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    mgr = make_manager(str(tmp_path / "lm"))
    assert mgr.latest_step() == 3
    with pytest.raises(ValueError, match=CONVERTER):
        restore_checkpoint(mgr, state_of(0))
    with pytest.raises(ValueError, match="orbax_to_torch_checkpoint"):
        worker.serving_params(worker.build_parser().parse_args(
            TINY_DECODE + ["--ckpt-dir", str(tmp_path)]), "cpu")


def test_a_directory_of_no_known_format_raises(tmp_path):
    (tmp_path / "4").mkdir()
    with pytest.raises(ValueError, match="not a checkpoint of this port"):
        restore_checkpoint(make_manager(str(tmp_path)), state_of(0))


def test_a_corrupt_leaf_raises(tmp_path):
    """Each leaf's CRC-32 is checked against the zip's record as it is
    read: a flipped byte raises naming the leaf."""
    import zipfile

    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state_of(0))
    path = tmp_path / "0" / "state.npz"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("params/ln_f/scale.npy")
    raw = bytearray(path.read_bytes())
    off = info.header_offset
    name_len = int.from_bytes(raw[off + 26:off + 28], "little")
    extra_len = int.from_bytes(raw[off + 28:off + 30], "little")
    # the member's last byte: leaf data, past the local and npy headers
    raw[off + 30 + name_len + extra_len + info.compress_size - 1] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=r"params/ln_f/scale.* corrupt"):
        restore_checkpoint(mgr, state_of(1))


def test_a_shape_mismatch_raises_naming_the_leaf(tmp_path):
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state_of(0))
    wider = dict(CFG, hidden=48)
    with pytest.raises(ValueError, match=r"params/embed/embedding.*shape"):
        restore_checkpoint(mgr, state_of(1, cfg=wider))
    with pytest.raises(ValueError, match=r"pos_embed/embedding.*shape"):
        restore_params(mgr, dict(CFG, num_heads=HEADS, max_seq=33),
                       device="cpu")
    # another depth: the checkpoint's extra layer is named
    with pytest.raises(ValueError, match=r"params/layer1/.* not in the model"):
        restore_params(mgr, dict(CFG, num_heads=HEADS, num_layers=1),
                       device="cpu")


def test_another_optimizer_raises(tmp_path):
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state_of(0, sgd()))
    with pytest.raises(ValueError, match="'sgd' optimizer state.*'adam'"):
        restore_checkpoint(mgr, state_of(1, adam()))


def test_saving_a_step_twice_replaces_it(tmp_path):
    state = state_of(0)
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state)
    lm_step(state, batches(1)[0])
    state.step = 0
    save_checkpoint(mgr, state)
    assert mgr.all_steps() == [0]
    assert sorted(os.listdir(tmp_path)) == ["0"]
    fresh = state_of(1)
    restore_checkpoint(mgr, fresh)
    assert_trees_equal(gather_state(fresh)[0], gather_state(state)[0])


def test_the_format_on_disk(tmp_path):
    """One uncompressed npz of /-joined leaves and a JSON record."""
    import zipfile

    state = state_of(0, adam())
    lm_step(state, batches(1)[0])
    mgr = make_manager(str(tmp_path))
    save_checkpoint(mgr, state)
    step_dir = tmp_path / "1"
    assert sorted(os.listdir(step_dir)) == ["checkpoint.json", "state.npz"]
    meta = json.loads((step_dir / "checkpoint.json").read_text())
    assert meta["step"] == 1 and meta["version"] == 1
    assert meta["optimizer"] == dict(name="adam", lr=3e-4, b1=0.9, b2=0.999,
                                     eps=1e-8)
    assert meta["model"] == dict(CFG, num_heads=HEADS)
    with zipfile.ZipFile(step_dir / "state.npz") as zf:
        assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_STORED}
    with np.load(step_dir / "state.npz") as z:
        names = set(z.files)
        assert {"step", "opt_state/count", "params/embed/embedding",
                "opt_state/mu/layer1/mlp_up/kernel",
                "opt_state/nu/ln_f/scale"} <= names
        assert z["step"].shape == () and z["step"].dtype == np.int32
        assert z["opt_state/count"].dtype == np.int32
        assert all(z[k].dtype == np.float32 for k in names
                   if k.startswith(("params/", "opt_state/mu", "opt_state/nu")))
    assert mgr.nbytes(1) == sum(os.path.getsize(step_dir / n)
                                for n in os.listdir(step_dir))


# -- the worker ----------------------------------------------------------------


def test_worker_resumes_and_saves(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    worker.main(TINY_LM + ck + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "CHECKPOINT_SAVED step=3" in out and "RESUMED" not in out
    # --ckpt-every 2 saved step 2 on the way; the final step 3 at the end
    assert make_manager(str(tmp_path / "lm")).all_steps() == [2, 3]
    worker.main(TINY_LM + ck + ["--steps", "2"])
    out = capsys.readouterr().out
    assert out.index("RESUMED step=3") < out.index("FIRST_STEP_DONE")
    assert "CHECKPOINT_SAVED step=5" in out
    assert make_manager(str(tmp_path / "lm")).all_steps() == [2, 3, 5]


def test_worker_warns_of_legacy_steps_at_the_root(tmp_path, caplog):
    (tmp_path / "7").mkdir()
    with caplog.at_level(logging.WARNING):
        worker.main(TINY_LM + ["--ckpt-dir", str(tmp_path), "--steps", "1"])
    assert "ignoring legacy checkpoints at" in caplog.text
    assert "(steps 7)" in caplog.text
    # never restored: the run starts at step 0
    assert make_manager(str(tmp_path / "lm")).all_steps() == [1]


def test_worker_serves_fresh_weights_without_a_checkpoint(tmp_path, caplog,
                                                          capsys):
    with caplog.at_level(logging.WARNING):
        worker.main(TINY_DECODE + ["--ckpt-dir", str(tmp_path)])
    assert f"no lm checkpoint under {tmp_path}; serving fresh" in caplog.text
    out = capsys.readouterr().out
    assert "RESTORED_FOR_SERVING" not in out and "DECODE_DONE" in out
    args = worker.build_parser().parse_args(TINY_DECODE)
    fresh, _, _ = worker.serving_params(args, "cpu")
    got, _, _ = worker.serving_params(worker.build_parser().parse_args(
        TINY_DECODE + ["--ckpt-dir", str(tmp_path)]), "cpu", announce=False)
    assert_trees_equal(got, fresh)


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_worker_serves_the_trained_weights(tmp_path, capsys, fp32):
    worker.main(TINY_LM + ["--ckpt-dir", str(tmp_path), "--steps", "2"])
    capsys.readouterr()
    extra = ["--serve-fp32"] if fp32 else []
    args = worker.build_parser().parse_args(
        TINY_DECODE + extra + ["--ckpt-dir", str(tmp_path)])
    params, cfg, dtype = worker.serving_params(args, "cpu")
    assert capsys.readouterr().out == "RESTORED_FOR_SERVING step=2\n"
    with np.load(tmp_path / "lm" / "2" / "state.npz") as z:
        for path, got in flat(params):
            want = torch.from_numpy(z[f"params/{path}"]).to(dtype)
            assert got.dtype == dtype and torch.equal(got, want), path
    worker.main(TINY_DECODE + extra + ["--serving", "paged",
                                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "RESTORED_FOR_SERVING step=2" in out
    assert "DECODE_DONE" in out


def test_worker_int8_quantizes_the_restored_weights(tmp_path, capsys):
    from kubegpu_tpu_torch.models.decoding import quantize_params_int8

    worker.main(TINY_LM + ["--ckpt-dir", str(tmp_path), "--steps", "1"])
    args = worker.build_parser().parse_args(
        TINY_DECODE + ["--int8", "--ckpt-dir", str(tmp_path)])
    params, _, _ = worker.serving_params(args, "cpu")
    out = capsys.readouterr().out
    assert out.endswith("RESTORED_FOR_SERVING step=1\n"
                        "SERVING_INT8 weight-only per-output-channel\n")
    bf16, _ = restore_params(make_manager(str(tmp_path / "lm")),
                             dict(CFG, num_heads=HEADS), device="cpu",
                             dtype=torch.bfloat16)
    assert_trees_equal(params, quantize_params_int8(bf16))


def test_worker_restores_a_trained_draft(tmp_path, capsys, caplog):
    """``--draft-ckpt-dir`` serves a draft trained by ``--model lm`` at
    the draft's dims (1 layer, hidden 128 in one head of 128), in bf16
    even under ``--serve-fp32`` as the JAX worker does; without a
    checkpoint there it warns and speculates with the fresh draft."""
    draft_dir = tmp_path / "draft"
    worker.main(["--model", "lm", "--vocab", "64", "--hidden", "128",
                 "--heads", "1", "--layers", "1", "--seq", "32",
                 "--batch-per-chip", "2", "--steps", "1", "--device", "cpu",
                 "--ckpt-dir", str(draft_dir)])
    capsys.readouterr()
    spec = ["--serving", "paged", "--speculate", "--spec-k", "2",
            "--seq", "32", "--serve-fp32"]
    args = worker.build_parser().parse_args(
        TINY_DECODE + spec + ["--draft-ckpt-dir", str(draft_dir)])
    dparams, heads, hidden = worker.draft_for(args, 33, "cpu")
    assert (heads, hidden) == (1, 128)
    assert capsys.readouterr().out == "RESTORED_DRAFT_FOR_SERVING\n"
    with np.load(draft_dir / "lm" / "1" / "state.npz") as z:
        for path, got in flat(dparams):
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, torch.from_numpy(
                z[f"params/{path}"]).to(torch.bfloat16)), path
    assert load_draft_checkpoint(
        str(tmp_path / "nothing"), vocab_size=64, num_layers=1, num_heads=1,
        hidden=128, max_seq=33, device="cpu") is None
    r = worker.run_decode(args)
    assert "RESTORED_DRAFT_FOR_SERVING" in capsys.readouterr().out
    assert r["spec_steps"] > 0
    plain = worker.run_decode(worker.build_parser().parse_args(
        TINY_DECODE + ["--serving", "paged", "--seq", "32", "--serve-fp32"]))
    assert r["outputs"] == plain["outputs"]   # greedy speculation is lossless
    with caplog.at_level(logging.WARNING):
        worker.draft_for(worker.build_parser().parse_args(
            TINY_DECODE + spec + ["--draft-ckpt-dir", str(tmp_path / "no")]),
            33, "cpu")
    assert "no draft checkpoint under" in caplog.text


def test_worker_rejects_a_checkpoint_of_another_width(tmp_path):
    worker.main(TINY_LM + ["--ckpt-dir", str(tmp_path), "--steps", "1"])
    args = worker.build_parser().parse_args(
        TINY_DECODE + ["--seq", "24", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="pos_embed/embedding.*shape"):
        worker.serving_params(args, "cpu")
