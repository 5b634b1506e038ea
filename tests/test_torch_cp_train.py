"""Context-parallel LM training in the port (``TransformerLM(
context_parallel=True, mesh=...)``, ``train.place_cp_lm``, ``lm_loss``
and ``sync_grads`` over a ``("data", "seq")`` mesh, worker ``--model
lm-cp``) against the JAX package's ``make_lm_train_step`` on a
``{"data": 2, "seq": 2}`` mesh.

The port's dp 2 x cp 2 step runs in one gang of four JAX-free processes
over gloo on the CPU (``parallel.launch.Gang``, rank bodies in
``tests/torch_cp_cases.py``), started once for the module; JAX's runs
here on four of the 8 CPU devices of ``tests/conftest.py`` under
``place_cp_lm``, from the same flax weights at float32.

- One step's loss within 1e-5 and every gradient leaf within rtol 1e-4,
  atol 1e-6 (``tests/test_torch_train.py``'s tolerances) of JAX's, for
  ring attention through its flash body (a 16-row shard) and its einsum
  body (136 rows), Ulysses, einsum attention (JAX's GSPMD computes it
  whole; the port gathers K/V over ``"seq"``), and ring and Ulysses
  with ``remat=True``; and of the port's one-device flash step.
- ``remat=True`` equals ``remat=False`` bit for bit.
- Three steps from a carried state with a non-zero momentum trace:
  losses, weights and momentum within 1e-5 of JAX's.
- The worker's ``--model lm-cp`` over four CPU ranks end to end, its
  refusals (the JAX worker's ``_split_mesh`` and ``--seq``), and a run
  resumed from ``--ckpt-dir`` (under ``DIR/lm-cp``) equal to an
  uninterrupted one bit for bit.
- The model's refusals: a 3-D mesh (``"model"`` and ``"seq"``, trained
  in ``tests/test_torch_3d_train.py``) without ``context_parallel=True``
  or with a vocab that does not divide by tp; ``"flash"`` over a
  ``"seq"`` axis.
"""

import re
import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.train import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_train_state,
    lm_loss as jax_lm_loss,
    make_lm_train_step,
    place_cp_lm as jax_place_cp_lm,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu.parallel.sharding import current_mesh
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import params_from_numpy, tree_map
from kubegpu_tpu_torch.models.train import (
    create_train_state,
    grad_tree,
    lm_grads,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
import torch_cp_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"data": 2, "seq": 2}
# max_seq holds the einsum body's 2 x 136 rows
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=273)
BATCH = 4
# the flash body's shard (16 rows, which ring_block_sizes tiles) and the
# einsum body's (136, which it does not)
FLASH_SEQ, EINSUM_SEQ = 32, 272
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
STEP_TOL = 1e-5
GANG_TIMEOUT_S = 300.0


def tokens_np(seed, seq=FLASH_SEQ):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, seq + 1)).astype(np.int32)


def jax_model(attn_impl, remat=False):
    return JaxTransformerLM(dtype=jnp.float32, attn_impl=attn_impl,
                            context_parallel=True, remat=remat, **CFG)


def jax_state(attn_impl, params, remat=False):
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={}, opt_state=tx.init(params),
                         apply_fn=jax_model(attn_impl, remat).apply, tx=tx)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_close(got, want, rtol, atol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_device_mesh(AXES, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_params():
    return jax_create_train_state(
        JaxTransformerLM(dtype=jnp.float32, attn_impl="einsum", **CFG),
        jax.random.PRNGKey(0), jnp.asarray(tokens_np(0))[:, :-1]).params


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(AXES, str(tmp_path_factory.mktemp("dp2cp2")), backend="gloo",
             devices=["cpu"] * 4, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


@pytest.fixture(scope="module")
def port_grads(gang, jax_params):
    """The gang's one-step loss and gradients by (attention, sequence
    length, remat), computed once each."""
    cache = {}

    def get(attn_impl, seq=FLASH_SEQ, remat=False):
        key = (attn_impl, seq, remat)
        if key not in cache:
            cache[key] = gang.run(cases.cp_grads, dict(
                params=np_tree(jax_params), cfg=CFG,
                model=dict(attn_impl=attn_impl, remat=remat),
                tokens=[tokens_np(2, seq)]))
        return cache[key]

    return get


CASES = [
    pytest.param("ring", FLASH_SEQ, False, id="ring-flash-body"),
    pytest.param("ring", EINSUM_SEQ, False, id="ring-einsum-body"),
    pytest.param("ulysses", FLASH_SEQ, False, id="ulysses"),
    pytest.param("einsum", FLASH_SEQ, False, id="einsum"),
    pytest.param("ring", FLASH_SEQ, True, id="ring-remat"),
    pytest.param("ulysses", FLASH_SEQ, True, id="ulysses-remat"),
]


@pytest.mark.parametrize("attn_impl, seq, remat", CASES)
def test_dp2_cp2_loss_and_gradients_match_the_jax_data2_seq2_mesh(
        jax_mesh, jax_params, port_grads, attn_impl, seq, remat):
    state, tokens = jax_place_cp_lm(jax_state(attn_impl, jax_params, remat),
                                    jnp.asarray(tokens_np(2, seq)), jax_mesh)
    with current_mesh(jax_mesh):
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p, t: jax_lm_loss(state, p, t)))(state.params, tokens)
    got = port_grads(attn_impl, seq, remat)
    np.testing.assert_allclose(got["loss"], float(loss_j), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"], np_tree(grads_j), GRAD_RTOL, GRAD_ATOL)
    # the CPU takes the twins: no kernel launched on any rank
    assert len(got["launches"]) == 4
    assert not any(n for r in got["launches"] for n in r.values())


@pytest.mark.parametrize("attn_impl, seq", [
    ("ring", FLASH_SEQ), ("ring", EINSUM_SEQ), ("ulysses", FLASH_SEQ),
    ("einsum", FLASH_SEQ)])
def test_dp2_cp2_matches_the_ports_one_device_step(jax_params, port_grads,
                                                   attn_impl, seq):
    model = TransformerLM(dtype=torch.float32, attn_impl="flash", **CFG)
    state = create_train_state(model, params_from_numpy(np_tree(jax_params)))
    loss = lm_grads(state, torch.from_numpy(tokens_np(2, seq)))
    got = port_grads(attn_impl, seq)
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"],
                       tree_map(lambda t: t.numpy(), grad_tree(state)),
                       GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_remat_equals_no_remat_on_the_mesh(port_grads, attn_impl):
    """The recomputed forward re-issues the ring's hops and all-to-alls
    in the same order on every rank, and computes the same bits."""
    a, b = port_grads(attn_impl), port_grads(attn_impl, remat=True)
    assert a["loss"] == b["loss"]
    for (pa, ga), (pb, gb) in zip(leaves(a["grads"]), leaves(b["grads"])):
        assert pa == pb and np.array_equal(ga, gb), pa


def test_three_carried_steps_match_make_lm_train_step(jax_mesh, jax_params,
                                                      gang):
    """One JAX step makes the momentum trace non-zero; the state is then
    carried across, whole on every rank, and both sides take the same
    three nesterov-SGD steps on the 2 x 2 mesh (ring, flash body)."""
    batches = [jnp.asarray(tokens_np(10 + i)) for i in range(4)]
    state, _ = jax_place_cp_lm(jax_state("ring", jax_params), batches[0],
                               jax_mesh)
    step = make_lm_train_step(jax_mesh, donate=False)
    state, _ = step(state, batches[0])
    got = gang.run(cases.cp_steps, dict(
        params=np_tree(state.params), trace=np_tree(state.opt_state[0].trace),
        step=int(state.step), cfg=CFG, model=dict(attn_impl="ring"),
        tokens=[np.asarray(b) for b in batches[1:]]))
    losses = []
    for tokens in batches[1:]:
        state, loss = step(state, tokens)
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert got["step"] == int(state.step) == 4
    assert_trees_close(got["params"], np_tree(state.params), STEP_TOL,
                       STEP_TOL)
    assert_trees_close(got["opt_state"]["trace"],
                       np_tree(state.opt_state[0].trace), STEP_TOL, STEP_TOL)


def test_the_data_seq_mesh_lays_ranks_out_as_jax(gang):
    """Rank r of ``{"data": 2, "seq": 2}`` sits at data ``r // 2``, seq
    ``r % 2`` (row-major, as JAX lays devices out); its "seq" group is
    its data row, its "data" group its seq column."""
    every = gang.run(cases.mesh_layout)
    for r, got in enumerate(every):
        d, c = r // 2, r % 2
        assert got["coords"] == (d, c)
        assert got["sizes"] == (2, 1)   # cp_size, tp_size
        assert got["groups"] == {"data": [c, c + 2],
                                 "seq": [2 * d, 2 * d + 1]}


def cp_mesh(axes, rank=0):
    return Mesh(size=int(np.prod(list(axes.values()))), rank=rank,
                device=torch.device("cpu"), backend="gloo",
                axis_names=tuple(axes), axis_sizes=tuple(axes.values()))


def test_the_model_refuses_what_this_slice_does_not_run():
    mesh_3d = cp_mesh({"data": 1, "model": 2, "seq": 2})
    with pytest.raises(ValueError, match="context_parallel=True"):
        TransformerLM(mesh=mesh_3d, attn_impl="ring", **CFG)
    with pytest.raises(ValueError, match="vocab_size 63 does not divide "
                                         "over tp=2"):
        TransformerLM(mesh=mesh_3d, context_parallel=True, attn_impl="ring",
                      **dict(CFG, vocab_size=63))
    with pytest.raises(ValueError, match="'flash' over a 'seq' axis"):
        TransformerLM(mesh=cp_mesh(AXES), context_parallel=True,
                      attn_impl="flash", **CFG)
    with pytest.raises(ValueError, match="context_parallel=True"):
        TransformerLM(mesh=cp_mesh(AXES), attn_impl="ring", **CFG)


LM_CP = ["--model", "lm-cp", "--vocab", "64", "--hidden", "32", "--heads",
         "4", "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
         "--device", "cpu"]


def test_lm_cp_worker_trains_dp2_cp2_over_four_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *LM_CP,
         "--steps", "3", "--cp", "2", "--cpu-ranks", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert re.search(r"^TRAINING_MESH data=2 seq=2 devices=cpu,cpu,cpu,cpu "
                     r"backend=gloo attn_impl=ring$", out, re.M), out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    # a rank's K (or V): 2 rows x 8 positions x 32 widths in bf16; one hop
    # of K and V forward, then K, V and the float32 dK, dV, then dK, dV
    # home: 12 of them a layer a step; host_staged stays 0 on the CPU
    kv = 2 * 8 * 32 * 2
    for rank in range(4):
        assert re.search(rf"^K3_LAUNCHES flash_forward=0 steps=3 layers=2 "
                         rf"device=cpu rank={rank}$", out, re.M), out
        assert re.search(rf"^CP_BYTES ring_shift={12 * kv * 2 * 3} "
                         rf"all_to_all=0 host_staged=0 steps=3 "
                         rf"rank={rank}$", out, re.M), out


@pytest.mark.parametrize("argv, match", [
    (["--cp", "3", "--cpu-ranks", "4"], "does not divide the device count 4"),
    (["--cp", "8", "--cpu-ranks", "4"], "exceeds the visible device count 4"),
    (["--cp", "2", "--cpu-ranks", "2", "--seq", "15"],
     "--seq 15 not divisible by cp=2"),
    (["--cp", "4", "--cpu-ranks", "4", "--attn-impl", "ulysses", "--heads",
      "2"], "--heads 2 not divisible by cp=4"),
])
def test_lm_cp_worker_refusals(argv, match):
    args = worker.build_parser().parse_args(LM_CP + argv)
    with pytest.raises(SystemExit, match=match):
        worker.run_lm(args)


def test_lm_cp_worker_counts_the_cards_and_reads_cp_not_tp(monkeypatch):
    """On the card the device count is the cards': ``--cp 2`` on one is
    refused; ``--tp`` is not read (``--cp 0`` takes every device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = worker.build_parser().parse_args(
        LM_CP[:-2] + ["--cp", "2"])
    with pytest.raises(SystemExit, match="exceeds the visible device count 1"):
        worker.training_mesh(args)
    args = worker.build_parser().parse_args(LM_CP[:-2] + ["--tp", "2"])
    assert worker.training_mesh(args) == (1, 1)
    args = worker.build_parser().parse_args(LM_CP + ["--cpu-ranks", "4",
                                                     "--tp", "4"])
    assert worker.training_mesh(args) == (1, 4)
    args.attn_impl = "flash"
    assert worker.cp_attn_impl(args) == "ring"


def saved(tmp, step):
    with np.load(tmp / "lm-cp" / str(step) / "state.npz") as z:
        return {k: z[k] for k in z.files}


def test_resumed_lm_cp_run_equals_the_uninterrupted_run(tmp_path, capsys):
    def train(root, steps):
        return worker.run_lm(worker.build_parser().parse_args(
            LM_CP + ["--cp", "2", "--cpu-ranks", "2", "--steps", str(steps),
                     "--ckpt-every", "100", "--ckpt-dir", str(root)]))

    straight = train(tmp_path / "straight", 4)
    first = train(tmp_path / "resumed", 2)
    assert "RESUMED" not in capsys.readouterr().out
    second = train(tmp_path / "resumed", 2)
    out = capsys.readouterr().out
    assert "RESUMED step=2" in out and "CHECKPOINT_SAVED step=4" in out
    assert straight["mesh"] == {"data": 1, "seq": 2}
    assert first["losses"] + second["losses"] == straight["losses"]
    a, b = saved(tmp_path / "resumed", 4), saved(tmp_path / "straight", 4)
    assert a.keys() == b.keys() and "step" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_lm_worker_trains_ring_and_ulysses_as_flash(attn_impl):
    """``--model lm`` has no ``"seq"`` axis: ``--attn-impl ring|ulysses``
    train as flash, as in the JAX worker (its model falls back to
    flash), to the same losses bit for bit."""
    base = ["--model", "lm"] + LM_CP[2:] + ["--steps", "3"]
    losses = {impl: worker.run_lm(worker.build_parser().parse_args(
        base + ["--attn-impl", impl]))["losses"]
        for impl in (attn_impl, "flash")}
    assert losses[attn_impl] == losses["flash"]
