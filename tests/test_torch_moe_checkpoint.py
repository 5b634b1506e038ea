"""MoE checkpoints in the port (``models/checkpoint.py`` over the expert
axis, ``tools/orbax_to_torch_checkpoint.py`` for the JAX worker's MoE
checkpoints), on the CPU at float32 weights:

- the worker's ``--model moe --ckpt-dir``: ``--steps 4`` and two runs of
  ``--steps 2`` (the second prints ``RESUMED step=2``) end with the same
  checkpoint under ``DIR/moe``, bit for bit, and the same losses, at one
  device and at dp 2 x ep 2 (``--ep 2 --cpu-ranks 4``), SGD and Adam;
- in a dp 2 x ep 2 gang: "2 steps, save, restore into fresh weights, 2
  steps" equals "4 steps" bit for bit; a dp 2 x ep 2 save restored on
  an ep 2 x tp 2 mesh (each rank its new shards) is the saved tree;
- the JAX worker's ``--model moe --ep 4 --tp 2`` Orbax checkpoint,
  converted, restores JAX's parameters and momentum exactly, on one
  device and on a dp 2 x ep 2 gang, and the port's worker resumes it.
"""

import os
import sys

import numpy as np
import pytest

from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_moe_cases as cases

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import orbax_to_torch_checkpoint as converter  # noqa: E402

TINY = ["--model", "moe", "--vocab", "64", "--hidden", "32", "--heads", "4",
        "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
        "--device", "cpu", "--ckpt-every", "100"]
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=17,
           num_experts=4)
INIT = dict(CFG)
INIT.pop("num_heads")
GANG_TIMEOUT_S = 300.0


def train(tmp, *extra):
    return worker.run_moe(worker.build_parser().parse_args(
        TINY + ["--ckpt-dir", str(tmp), *extra]))


def saved(root, step):
    with np.load(os.path.join(str(root), "moe", str(step),
                              "state.npz")) as z:
        return {k: z[k] for k in z.files}


def assert_same_checkpoint(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mesh", [
    ["--num-experts", "4", "--moe-router", "top2"],
    ["--ep", "2", "--cpu-ranks", "4", "--num-experts", "4"],
], ids=["one-device", "dp2-ep2"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, capsys, mesh,
                                                   optimizer):
    opt = ["--optimizer", optimizer]
    straight = train(tmp_path / "straight", "--steps", "4", *opt, *mesh)
    first = train(tmp_path / "resumed", "--steps", "2", *opt, *mesh)
    assert "RESUMED" not in capsys.readouterr().out
    second = train(tmp_path / "resumed", "--steps", "2", *opt, *mesh)
    out = capsys.readouterr().out
    assert "RESUMED step=2" in out and "CHECKPOINT_SAVED step=4" in out
    assert second["step"] == straight["step"] == 4
    assert first["losses"] + second["losses"] == straight["losses"]
    got = saved(tmp_path / "resumed", 4)
    assert_same_checkpoint(got, saved(tmp_path / "straight", 4))
    assert got["params/layer0/moe_mlp/w_up"].shape == (4, 32, 128)
    if "--ep" in mesh:
        assert straight["mesh"] == {"data": 2, "expert": 2}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    made = {name: Gang(axes, str(tmp_path_factory.mktemp(name)),
                       backend="gloo", devices=["cpu"] * 4,
                       timeout_s=GANG_TIMEOUT_S)
            for name, axes in (("dp2_ep2", {"data": 2, "expert": 2}),
                               ("ep2_tp2", {"data": 1, "expert": 2,
                                            "model": 2}))}
    yield made
    for g in made.values():
        g.close()


def tokens_np(seed):
    return np.random.RandomState(seed).randint(
        0, 64, size=(4, 17)).astype(np.int32)


def test_gang_save_resume_is_bit_for_bit_and_restores_on_another_mesh(
        gangs, tmp_path):
    spec = dict(params={"init": INIT, "seed": 0},
                fresh={"init": INIT, "seed": 5}, cfg=CFG,
                model=dict(router_type="top2", dispatch_impl="gather"),
                tokens=[tokens_np(i) for i in range(4)], save_after=2,
                dir=str(tmp_path / "ckpt"))
    got = gangs["dp2_ep2"].run(cases.moe_save_resume, spec)
    straight, resumed = got["straight"], got["resumed"]
    assert resumed["losses"] == straight["losses"]
    assert resumed["step"] == straight["step"] == 4
    for name in ("params", "opt_state"):
        for path, v in cases_leaves(straight[name]):
            assert np.array_equal(dict(cases_leaves(resumed[name]))[path],
                                  v), path
    # the step-2 save, restored onto every rank's shards of another mesh
    back = gangs["ep2_tp2"].run(cases.moe_restore_whole, dict(
        spec, params={"init": INIT, "seed": 9}))
    from kubegpu_tpu_torch.models.checkpoint import make_manager

    with make_manager(spec["dir"]).open(2) as ckpt:
        for path, v in cases_leaves(back["params"]):
            assert np.array_equal(ckpt.leaf(f"params/{path}"), v), path
        for path, v in cases_leaves(back["opt_state"]["trace"]):
            assert np.array_equal(ckpt.leaf(f"opt_state/trace/{path}"),
                                  v), path
    assert back["step"] == 2


def cases_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from cases_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


JAX_TRAIN = ["--model", "moe", "--vocab", "64", "--hidden", "32", "--heads",
             "4", "--layers", "2", "--seq", "16", "--steps", "3",
             "--batch-per-chip", "1", "--data-pool", "2", "--ep", "4",
             "--tp", "2"]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The JAX worker's MoE Orbax checkpoint (8 CPU devices: data 1,
    expert 4, model 2; 4 experts), its tree read back, and its
    conversion."""
    from kubegpu_tpu.models import worker as jax_worker

    root = tmp_path_factory.mktemp("jax-moe")
    src, dst = str(root / "jax"), str(root / "port")
    assert jax_worker.main(JAX_TRAIN + ["--ckpt-dir", src]) == 0
    assert converter.convert(src, dst, "moe") == os.path.join(dst, "moe",
                                                              "3")
    tree = converter.read_orbax(os.path.join(src, "moe", "3"))
    return dict(src=src, dst=dst, tree=tree)


def test_the_converter_records_the_moe_model(converted):
    from kubegpu_tpu_torch.models.checkpoint import make_manager

    mgr = make_manager(os.path.join(converted["dst"], "moe"))
    meta = mgr.read_meta(3)
    assert meta["optimizer"] == dict(name="sgd", lr=None)
    assert meta["model"] == dict(
        vocab_size=64, hidden=32, max_seq=17, num_layers=2, num_heads=None,
        family="moe", num_experts=4, mlp_ratio=4, capacity_factor=None,
        router_type=None, dispatch_impl=None)
    assert converter.MODELS.index("moe") >= 0


@pytest.mark.parametrize("where", ["one-device", "dp2-ep2"])
def test_a_converted_jax_checkpoint_restores_jax_parameters_exactly(
        converted, gangs, where):
    spec = dict(params={"init": INIT, "seed": 3}, cfg=CFG,
                dir=os.path.join(converted["dst"], "moe"))
    if where == "one-device":
        got = cases.moe_restore_whole(None, spec)
    else:
        got = gangs["dp2_ep2"].run(cases.moe_restore_whole, spec)
    tree = converted["tree"]
    assert got["step"] == 3
    want = dict(cases_leaves(jax_np(tree["params"])))
    have = dict(cases_leaves(got["params"]))
    assert have.keys() == want.keys()
    for path in want:
        assert np.array_equal(have[path], want[path]), path
    trace = dict(cases_leaves(jax_np(tree["opt_state"][0]["trace"])))
    for path, v in cases_leaves(got["opt_state"]["trace"]):
        assert np.array_equal(v, trace[path]), path


def jax_np(tree):
    return {k: jax_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_the_port_worker_resumes_the_converted_checkpoint(converted,
                                                          capsys, tmp_path):
    import shutil

    d = tmp_path / "resume"
    shutil.copytree(converted["dst"], d)
    r = train(d, "--steps", "1", "--num-experts", "4")
    out = capsys.readouterr().out
    assert "RESUMED step=3" in out and "CHECKPOINT_SAVED step=4" in out
    assert r["step"] == 4 and np.isfinite(r["losses"]).all()
