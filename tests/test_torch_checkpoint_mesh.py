"""Checkpoints over a ``("data", "model")`` mesh, library level, on the
CPU without JAX: in a dp 2 x tp 2 gang of four gloo ranks "train 2,
save, restore into fresh weights, train 2" equals "train 4" bit for bit
(losses, weights, optimizer state), for SGD and for Adam; and the
gang's checkpoint, which holds the whole tree, restores on other meshes:
at one device and at tp 2, every leaf bit for bit what the gang saved,
and one device trains on from it as the gang does (float32, 1e-5: the
mesh sums in another order)."""

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch.models.checkpoint import (
    make_manager,
    restore_checkpoint,
)
from kubegpu_tpu_torch.models.params import init_params, params_from_numpy
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    gather_state,
    lm_step,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_tp_cases as cases

AXES = {"data": 2, "model": 2}
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=33)
MODEL = dict(attn_impl="einsum", sequence_parallel=True)
STEP_TOL = 1e-5
OPTIMIZERS = {"sgd": sgd(), "adam": adam(lr=1e-2)}


def np_tree(seed):
    tree = init_params({k: v for k, v in CFG.items() if k != "num_heads"},
                       torch.Generator().manual_seed(seed), torch.float32,
                       "cpu")
    return cases._np(tree)


def tokens(n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=(4, 33)).astype(np.int32)
            for _ in range(n)]


def flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, np.asarray(v)


def assert_equal_trees(a, b):
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(AXES, str(tmp_path_factory.mktemp("ckpt-dp2tp2")),
             backend="gloo", devices=["cpu"] * 4, timeout_s=300.0)
    yield g
    g.close()


@pytest.fixture(scope="module")
def gang_runs(gang, tmp_path_factory):
    out = {}
    for name, optimizer in OPTIMIZERS.items():
        d = str(tmp_path_factory.mktemp(f"ckpt-{name}"))
        out[name] = d, gang.run(cases.train_save_resume, dict(
            params=np_tree(0), fresh=np_tree(1), cfg=CFG, model=MODEL,
            optimizer=optimizer, tokens=tokens(4), save_after=2, dir=d))
    return out


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_on_the_mesh_equals_the_uninterrupted_run(gang_runs, name):
    _, got = gang_runs[name]
    straight, resumed = got["straight"], got["resumed"]
    assert resumed["step"] == straight["step"] == 4
    assert resumed["losses"] == straight["losses"]
    assert_equal_trees(resumed["params"], straight["params"])
    assert_equal_trees(resumed["opt_state"], straight["opt_state"])
    assert set(resumed["opt_state"]) == (
        {"trace"} if name == "sgd" else {"count", "mu", "nu"})


def saved_tree(directory, step, root):
    with np.load(f"{directory}/{step}/state.npz") as z:
        out = {}
        for k in z.files:
            if not k.startswith(root + "/"):
                continue
            node = out
            parts = k.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[k]
    return out


def one_device(name, seed=2):
    model = TransformerLM(dtype=torch.float32, attn_impl="einsum", **CFG)
    return create_train_state(model, params_from_numpy(np_tree(seed)),
                              optimizer=OPTIMIZERS[name])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_a_dp2_tp2_checkpoint_restores_at_one_device(gang_runs, name):
    d, got = gang_runs[name]
    state = one_device(name)
    restore_checkpoint(make_manager(d), state)
    assert state.step == 2
    params, opt_state = gather_state(state)
    assert_equal_trees(cases._np(params), saved_tree(d, 2, "params"))
    assert_equal_trees(cases._np_opt(opt_state), saved_tree(d, 2, "opt_state"))
    # one device trains on from the gang's step 2 as the gang did
    losses = [lm_step(state, torch.from_numpy(t)).item()
              for t in tokens(4)[2:]]
    np.testing.assert_allclose(losses, got["resumed"]["losses"][2:],
                               rtol=STEP_TOL, atol=STEP_TOL)
    for path, want in flat(got["resumed"]["params"]):
        np.testing.assert_allclose(dict(flat(cases._np(state.params)))[path],
                                   want, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=path)


def test_a_dp2_tp2_checkpoint_restores_at_tp2(gang_runs, tmp_path):
    with Gang(2, str(tmp_path), backend="gloo", devices=["cpu"] * 2,
              timeout_s=300.0) as tp2:
        for name in OPTIMIZERS:
            d, _ = gang_runs[name]
            got = tp2.run(cases.restore_whole, dict(
                params=np_tree(2), cfg=CFG, model=MODEL,
                optimizer=OPTIMIZERS[name], dir=d))
            assert got["step"] == 2
            assert_equal_trees(got["params"], saved_tree(d, 2, "params"))
            assert_equal_trees(got["opt_state"],
                               saved_tree(d, 2, "opt_state"))
