"""Pipeline-parallel LM training in the port (``PipelineLM``,
``place_pipeline_lm``, ``pipeline_lm_grads``/``pipeline_lm_step``) against
the JAX package's ``pipeline_lm_logits`` gradients and
``make_pipeline_lm_train_step`` on its meshes, and the worker's ``--model
pp``.

The port's meshes run in gangs of JAX-free processes over gloo on the
CPU (``parallel.launch.Gang``, rank bodies in ``tests/torch_pp_cases.py``),
one gang a mesh, started once for the module; JAX's run on its 8 CPU
devices of ``tests/conftest.py``, from the same weights (the JAX init's,
as numpy) at float32, rtol = atol = 1e-5:

- one step's loss and EVERY gradient leaf, gathered whole, the
  embeddings, ``ln_f_*`` and ``lm_head`` included (their cotangents
  cross the entry and the broadcast), against JAX's ``value_and_grad``
  of ``cross_entropy(pipeline_lm_logits)`` on the same mesh: GPipe on
  ``{"pipe": 2}``, circular V 2 on ``{"pipe": 2}``, PP x TP on ``{"pipe":
  2, "model": 2}``; and against the port's one device;
- three carried non-Nesterov SGD steps (``optax.sgd(0.1, momentum=0.9)``,
  the JAX worker's) against ``make_pipeline_lm_train_step`` on each of
  those meshes: losses, weights and momentum;
- ``place_pipeline_lm``'s parts: each rank's stage (or round slices)
  and TP shard of every block leaf and of its momentum;
- the worker: ``--model pp --cpu-ranks 2`` and ``--pp-rounds 2
  --microbatches 4`` print their lines and the hops' exact bytes; the
  ``{"pipe": 2}`` runs' losses equal one rank's at the same depth; the
  JAX worker's refusals; ``--ckpt-dir`` warned and ignored.
"""

import logging
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import worker as jax_worker
from kubegpu_tpu.models.pipeline_lm import (
    init_pipeline_lm as jax_init_pipeline_lm,
    make_pipeline_lm_train_step,
    pipeline_lm_logits as jax_pipeline_lm_logits,
    place_pipeline_lm as jax_place_pipeline_lm,
    to_circular_layout as jax_to_circular_layout,
)
from kubegpu_tpu.models.train import cross_entropy as jax_cross_entropy
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.params import params_from_numpy, tree_map
from kubegpu_tpu_torch.models.pipeline_lm import (
    PipelineLM,
    pipeline_rules,
    place_pipeline_lm,
)
from kubegpu_tpu_torch.models.train import sgd
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
from kubegpu_tpu_torch.parallel.sharding import shard_dims
import torch_pp_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GANG_TIMEOUT_S = 300.0
MESHES = {"pipe2": {"pipe": 2}, "pipe2_model2": {"pipe": 2, "model": 2}}
VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH, MICRO = 64, 32, 4, 2, 16, 8, 4
# (mesh, rounds, model_axis)
RUNS = {"gpipe": ("pipe2", 1, None), "circular": ("pipe2", 2, None),
        "pp_tp": ("pipe2_model2", 1, "model")}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    made = {name: Gang(axes, str(tmp_path_factory.mktemp(name)),
                       backend="gloo", devices=["cpu"] * math.prod(
                           axes.values()), timeout_s=GANG_TIMEOUT_S)
            for name, axes in MESHES.items()}
    yield made
    for g in made.values():
        g.close()


def jax_mesh(axes):
    return jax_device_mesh(axes, devices=jax.devices()[:math.prod(
        axes.values())])


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def windows(seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(BATCH, SEQ + 1)).astype(np.int32)


STEPS = [windows(10 + i) for i in range(3)]


def run_params(name):
    """JAX's init of the run's depth (2 stages x rounds), in its
    layout."""
    mesh_name, rounds, _ = RUNS[name]
    p = MESHES[mesh_name]["pipe"]
    params = jax_init_pipeline_lm(
        jax.random.PRNGKey(0), vocab_size=VOCAB, num_stages=p * rounds,
        layers_per_stage=LAYERS, hidden=HIDDEN, max_seq=SEQ + 1)
    return jax_to_circular_layout(params, p) if rounds > 1 else params


def spec(name, **kw):
    mesh_name, rounds, model_axis = RUNS[name]
    p = MESHES[mesh_name]["pipe"]
    return dict(params=np_tree(run_params(name)), tokens=STEPS,
                cfg=dict(vocab_size=VOCAB, num_stages=p * rounds,
                         layers_per_stage=LAYERS, hidden=HIDDEN,
                         num_heads=HEADS, num_microbatches=MICRO,
                         max_seq=SEQ + 1, num_rounds=rounds,
                         model_axis=model_axis), **kw)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_close(got, want, tol=TOL):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path].reshape(w.shape), w, rtol=tol,
                                   atol=tol, err_msg=path)


@pytest.fixture(scope="module")
def port_steps(gangs):
    """Each run's three steps on its gang, computed once each."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = gangs[RUNS[name][0]].run(cases.pp_steps,
                                                   spec(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(RUNS))
def test_every_gradient_leaf_matches_jax_on_its_mesh(port_steps, name):
    mesh_name, rounds, model_axis = RUNS[name]
    mesh = jax_mesh(MESHES[mesh_name])
    tokens = jnp.asarray(STEPS[0])

    def loss_fn(params):
        logits = jax_pipeline_lm_logits(
            params, tokens[:, :-1], mesh, num_heads=HEADS,
            num_microbatches=MICRO, num_rounds=rounds,
            model_axis=model_axis)
        return jax_cross_entropy(logits, tokens[:, 1:])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(run_params(name))
    got = port_steps(name)
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=TOL,
                               atol=TOL)
    assert_trees_close(got["grads"], np_tree(grads))


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_matches_the_ports_one_device(port_steps, name):
    """One device runs the same stack as rounds over one stage: the same
    losses, first gradients, weights and momentum."""
    mesh_name, rounds, _ = RUNS[name]
    p = MESHES[mesh_name]["pipe"]
    flat = jax.tree.map(lambda a: a.reshape((p * rounds, 1) + a.shape[
        2 if rounds > 1 else 1:]), dict(run_params(name)["blocks"]))
    one_spec = spec(name)
    one_spec["params"] = dict(one_spec["params"], blocks=np_tree(flat))
    one_spec["cfg"] = dict(one_spec["cfg"], num_rounds=p * rounds,
                           model_axis=None)
    one = cases.pp_steps(None, one_spec)
    got = port_steps(name)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TOL,
                               atol=TOL)
    for key in ("grads", "params", "trace"):
        assert_trees_close(got[key], one[key])
    assert got["step"] == one["step"] == 3


@pytest.mark.parametrize("name", list(RUNS))
def test_three_sgd_steps_match_the_jax_train_step(port_steps, name):
    mesh_name, rounds, model_axis = RUNS[name]
    mesh = jax_mesh(MESHES[mesh_name])
    tx = optax.sgd(0.1, momentum=0.9)
    params = run_params(name)
    opt = tx.init(params)
    params, opt, _ = jax_place_pipeline_lm(
        params, opt, jnp.asarray(STEPS[0]), mesh, num_rounds=rounds,
        model_axis=model_axis)
    step = make_pipeline_lm_train_step(
        mesh, tx, num_heads=HEADS, num_microbatches=MICRO,
        num_rounds=rounds, model_axis=model_axis, donate=False)
    losses = []
    for t in STEPS:
        params, opt, loss = step(params, opt, jnp.asarray(t))
        losses.append(float(loss))
    got = port_steps(name)
    np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=TOL)
    assert_trees_close(got["params"], np_tree(params))
    assert_trees_close(got["trace"], np_tree(opt[0].trace))


@pytest.mark.parametrize("name", list(RUNS))
def test_place_keeps_each_ranks_stage_and_shard(name):
    """Each rank's leaves (and momentum) are its slices of the whole
    tree: the block leaves' stage dim (dim 0, circular dim 1) over
    "pipe", under PP x TP wq/wk/wv/w1 dim 3 and wo/w2 dim 2 over
    "model"; the rest whole."""
    mesh_name, rounds, model_axis = RUNS[name]
    axes = MESHES[mesh_name]
    s = spec(name)
    whole = params_from_numpy(s["params"])
    trace = tree_map(lambda t: t + 1.0, whole)
    rules = pipeline_rules(rounds, model_axis=model_axis)
    assert shard_dims("lm_head", rules) == {}
    assert shard_dims("blocks/ln1_scale", rules) == {"pipe": int(rounds > 1)}
    if model_axis:
        assert shard_dims("blocks/wq", rules) == {"pipe": 0, "model": 3}
        assert shard_dims("blocks/w2", rules) == {"pipe": 0, "model": 2}
    for rank in range(math.prod(axes.values())):
        mesh = Mesh(size=math.prod(axes.values()), rank=rank,
                    device=torch.device("cpu"), backend="gloo",
                    axis_names=tuple(axes),
                    axis_sizes=tuple(axes.values()) if len(axes) > 1 else ())
        model = PipelineLM(mesh=mesh, **s["cfg"])
        state = place_pipeline_lm(model, whole, opt_state={"trace": trace},
                                  optimizer=sgd(nesterov=False))
        mom = {n.replace(".", "/"): state.opt.state[p]["momentum_buffer"]
               for n, p in model.named_parameters()}
        got = {n.replace(".", "/"): p.detach()
               for n, p in model.named_parameters()}
        assert got.keys() == dict(leaves(s["params"])).keys()
        for path, w in leaves(s["params"]):
            want = w
            for axis, dim in shard_dims(path, rules).items():
                k = want.shape[dim] // axes[axis]
                idx = [slice(None)] * want.ndim
                c = mesh.coord(axis)
                idx[dim] = slice(c * k, (c + 1) * k)
                want = want[tuple(idx)]
            np.testing.assert_array_equal(got[path].numpy(), want,
                                          err_msg=path)
            np.testing.assert_array_equal(mom[path].numpy(), want + 1.0,
                                          err_msg=path)
        # a rank's block elements: 1/pipe of each leaf, 1/tp more of
        # each TP-cut kernel
        block = sum(p.numel() for n, p in model.named_parameters()
                    if n.startswith("blocks."))
        assert block == sum(
            w.size // math.prod(axes[a] for a in shard_dims(path, rules))
            for path, w in leaves(s["params"]) if path.startswith("blocks/"))


# -- the worker -------------------------------------------------------------------

PP_TINY = ["--model", "pp", "--vocab", "64", "--hidden", "32", "--heads",
           "4", "--seq", "16", "--batch-per-chip", "2", "--steps", "3",
           "--device", "cpu"]


@pytest.fixture(scope="module")
def one_rank():
    """One rank at 4 layers, the depth of the mesh runs below."""
    return worker.run_pp(worker.build_parser().parse_args(
        PP_TINY + ["--layers", "4"]))


@pytest.mark.parametrize("extra,hops", [
    # GPipe, 4 microbatches: 4 hops a step forward from stage 0, 4
    # backward from stage 1
    (["--cpu-ranks", "2", "--layers", "2"], 4),
    # circular, 2 rounds of 2 stages of 1 layer: 8 hops each way a step on
    # each stage
    (["--cpu-ranks", "2", "--layers", "1", "--pp-rounds", "2",
      "--microbatches", "4"], 16),
], ids=["gpipe", "circular"])
def test_pp_worker_trains_the_one_rank_model_over_cpu_ranks(
        one_rank, capsys, extra, hops):
    """The mesh's lines, the hops' exact bytes, and the one rank's
    losses: the stages draw the tree one rank draws at the same
    depth."""
    capsys.readouterr()
    r = worker.run_pp(worker.build_parser().parse_args(PP_TINY + extra))
    worker.report_lm(r)
    out = capsys.readouterr().out
    assert re.search(r"^TRAINING_MESH pipe=2 devices=cpu,cpu backend=gloo$",
                     out, re.M), out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    layers = extra[extra.index("--layers") + 1]
    microbatch = 2 * 16 * 32 * 4   # --batch-per-chip x seq x hidden, f32
    for rank in range(2):
        assert re.search(rf"^K3_LAUNCHES flash_forward=0 steps=3 "
                         rf"layers={layers} device=cpu rank={rank}$", out,
                         re.M), out
        assert re.search(rf"^PP_BYTES hops={hops * microbatch * 3} "
                         rf"host_staged=0 steps=3 rank={rank}$", out,
                         re.M), out
    assert r["mesh"] == {"pipe": 2} and "mesh" not in one_rank
    np.testing.assert_allclose(r["losses"], one_rank["losses"], rtol=TOL,
                               atol=TOL)
    assert r["tokens_per_step"] == one_rank["tokens_per_step"] == 4 * 2 * 16


def test_pp_worker_entry_point_at_one_device():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *PP_TINY,
         "--layers", "2"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "TRAINING_MESH" not in out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    assert re.search(r"^K3_LAUNCHES flash_forward=0 steps=3 layers=2 "
                     r"device=cpu$", out, re.M), out


@pytest.mark.parametrize("bad,match", [
    (["--pp-stages", "3"], "--pp-stages 3 does not divide 8 devices"),
    (["--pp-rounds", "2", "--microbatches", "2"],
     "--pp-rounds 2 (circular schedule) needs --microbatches >= stages "
     "(2 < 8)"),
], ids=["stages", "circular-microbatches"])
def test_pp_worker_refuses_what_jax_refuses(bad, match):
    """On 8 devices (JAX's CPU mesh; ``--cpu-ranks 8`` for the port)."""
    with pytest.raises(SystemExit, match=re.escape(match)):
        jax_worker.main(["--model", "pp", "--steps", "1", *bad])
    with pytest.raises(SystemExit, match=re.escape(match)):
        worker.main(PP_TINY + ["--cpu-ranks", "8", *bad])


def test_pp_worker_refuses_a_pod_gang_and_odd_heads(monkeypatch):
    with pytest.raises(SystemExit, match="--hidden 30 not divisible by "
                       "--heads 4"):
        worker.main(PP_TINY + ["--hidden", "30"])
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit, match="JAX_NUM_PROCESSES=2"):
        worker.main(PP_TINY)


def test_pp_worker_warns_on_ckpt_dir_and_saves_nothing(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=worker.log.name):
        r = worker.run_pp(worker.build_parser().parse_args(
            PP_TINY + ["--steps", "2", "--ckpt-dir", str(tmp_path)]))
    assert "--ckpt-dir is not supported for --model pp; ignoring" in \
        caplog.text
    assert list(tmp_path.iterdir()) == []
    assert "checkpoint" not in r and len(r["losses"]) == 2


def test_pp_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``--device`` defaults to the card, and without one the worker and
    the init raise rather than train on the CPU."""
    from kubegpu_tpu_torch.models.pipeline_lm import init_pipeline_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.run_pp(worker.build_parser().parse_args(["--model", "pp"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pipeline_lm(torch.Generator(), vocab_size=8, num_stages=1,
                         layers_per_stage=1, hidden=8)
