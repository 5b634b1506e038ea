"""Expert-parallel MoE training in the port (``MoeTransformerLM(mesh=
...)``, ``train.place_moe``/``moe_grads``/``moe_step``, the expert
axis's collectives) against the JAX package's MoE step on its meshes,
and the worker's ``--model moe``.

The port's meshes run in gangs of four JAX-free processes over gloo on
the CPU (``parallel.launch.Gang``, rank bodies in
``tests/torch_moe_cases.py``), one gang a mesh, started once for the
module; JAX's run here on four of the 8 CPU devices of
``tests/conftest.py``, from the same flax weights at float32:

- dp 2 x ep 2 (``{"data": 2, "expert": 2}``) and ep 2 x tp 2 at data 1
  (``{"data": 1, "expert": 2, "model": 2}``), for ``top1``/einsum,
  ``top2``/gather and ``expert_choice``: one step's loss and aux within
  1e-5 and every gradient leaf, gathered whole, within rtol=atol 1e-4 of
  JAX's ``value_and_grad`` of ``moe_loss`` on the same mesh, and of the
  port's one device; every rank gathers the same bits (the parameters
  every rank holds whole end the backward equal along ``"expert"`` and
  ``"model"``);
- three ``moe_step``s on dp 2 x ep 2 against JAX's
  ``make_moe_train_step`` on its 2 x 2 mesh, and on both meshes against
  the port's one device (losses, auxes, weights, momentum within 1e-5);
- the expert axis's collectives forward and backward on every rank;
  ``place_moe``'s shards; the token rows of every rank of a data shard;
- the worker: ``--model moe --ep 2 --cpu-ranks 2``, ``--ep 2 --tp 2
  --cpu-ranks 4`` and ``--moe-router top2 --moe-dispatch gather`` print
  ``TRAINING_MESH`` and ``tokens_per_sec``; ``--ep 3`` on 2 ranks and
  ``--tp 3`` are refused as in JAX.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import MoeTransformerLM as JaxMoeTransformerLM
from kubegpu_tpu.models.data import (
    synthetic_token_batches_for_mesh as jax_batches_for_mesh,
)
from kubegpu_tpu.models.train import (
    create_train_state as jax_create_train_state,
    make_moe_train_step,
    moe_loss as jax_moe_loss,
    place_moe as jax_place_moe,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu.parallel.sharding import current_mesh
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.data import synthetic_token_batches_for_mesh
from kubegpu_tpu_torch.models.moe import MoeTransformerLM
from kubegpu_tpu_torch.models.params import params_from_numpy, tree_map
from kubegpu_tpu_torch.models.train import (
    gather_state,
    grad_tree,
    moe_grads,
    moe_step,
    place_moe,
)
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
from kubegpu_tpu_torch.parallel.sharding import (
    MOE_EP_RULES,
    MOE_EP_TP_RULES,
    shard_dims,
)
import torch_moe_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"dp2_ep2": {"data": 2, "expert": 2},
          "ep2_tp2": {"data": 1, "expert": 2, "model": 2}}
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=17,
           num_experts=4)
BATCH, SEQ = 4, 16
ROUTES = [dict(router_type="top1", dispatch_impl="einsum"),
          dict(router_type="top2", dispatch_impl="gather"),
          dict(router_type="expert_choice")]
ROUTE_IDS = ["top1-einsum", "top2-gather", "expert_choice"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
GANG_TIMEOUT_S = 300.0


def tokens_np(seed):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


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


def jax_model(route):
    return JaxMoeTransformerLM(dtype=jnp.float32, **CFG, **route)


@pytest.fixture(scope="module")
def jax_params():
    return jax_create_train_state(
        jax_model(ROUTES[0]), jax.random.PRNGKey(0),
        jnp.asarray(tokens_np(0))[:, :-1]).params


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    made = {name: Gang(axes, str(tmp_path_factory.mktemp(name)),
                       backend="gloo", devices=["cpu"] * 4,
                       timeout_s=GANG_TIMEOUT_S)
            for name, axes in MESHES.items()}
    yield made
    for g in made.values():
        g.close()


def spec(jax_params, route, tokens):
    return dict(params=np_tree(jax_params), cfg=CFG, model=route,
                tokens=tokens)


@pytest.fixture(scope="module")
def port_grads(gangs, jax_params):
    """Each mesh's one-step loss, aux and whole gradients by route,
    computed once each."""
    cache = {}

    def get(mesh_name, i):
        if (mesh_name, i) not in cache:
            cache[mesh_name, i] = gangs[mesh_name].run(
                cases.moe_grads, spec(jax_params, ROUTES[i],
                                      [tokens_np(2)]))
        return cache[mesh_name, i]

    return get


def jax_mesh_grads(jax_params, route, mesh_name):
    mesh = jax_device_mesh(MESHES[mesh_name], devices=jax.devices()[:4])
    state = jax_create_train_state(
        jax_model(route), jax.random.PRNGKey(0),
        jnp.asarray(tokens_np(0))[:, :-1]).replace(params=jax_params)
    state, tokens = jax_place_moe(state, jnp.asarray(tokens_np(2)), mesh)
    with current_mesh(mesh):
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_moe_loss(state, p, t, 0.01), has_aux=True))(
            state.params, tokens)
    return float(loss), float(aux), np_tree(grads)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("i", range(3), ids=ROUTE_IDS)
def test_mesh_loss_aux_and_gradients_match_the_jax_mesh(
        jax_params, port_grads, mesh_name, i):
    loss_j, aux_j, grads_j = jax_mesh_grads(jax_params, ROUTES[i], mesh_name)
    got = port_grads(mesh_name, i)
    np.testing.assert_allclose(got["loss"], loss_j, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["aux"], aux_j, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"], grads_j, GRAD_TOL, GRAD_TOL)
    # the CPU takes the twins: no kernel launched
    assert not any(got["launches"].values())


def one_device(jax_params, route):
    model = MoeTransformerLM(dtype=torch.float32, **CFG, **route)
    return place_moe(model, params_from_numpy(np_tree(jax_params)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("i", range(3), ids=ROUTE_IDS)
def test_mesh_matches_the_ports_one_device(jax_params, port_grads,
                                           mesh_name, i):
    state = one_device(jax_params, ROUTES[i])
    loss, aux = moe_grads(state, torch.from_numpy(tokens_np(2)))
    from kubegpu_tpu_torch.models.moe import moe_router_stats

    _, drop = moe_router_stats(state.model,
                               torch.from_numpy(tokens_np(2))[:, :-1])
    got = port_grads(mesh_name, i)
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["aux"], aux.item(), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    # the drop rate is the whole batch's on every mesh
    assert abs(got["drop"] - drop.item()) <= 1e-6
    assert_trees_close(got["grads"],
                       tree_map(lambda t: t.numpy(), grad_tree(state)),
                       GRAD_TOL, GRAD_TOL)


STEPS = [tokens_np(10 + i) for i in range(3)]


@pytest.fixture(scope="module")
def jax_mesh_steps(jax_params):
    """Three ``make_moe_train_step`` steps of ``top1`` on JAX's 2 x 2
    mesh."""
    mesh = jax_device_mesh(MESHES["dp2_ep2"], devices=jax.devices()[:4])
    state = jax_create_train_state(
        jax_model(ROUTES[0]), jax.random.PRNGKey(0),
        jnp.asarray(tokens_np(0))[:, :-1]).replace(params=jax_params)
    state, _ = jax_place_moe(state, jnp.asarray(STEPS[0]), mesh)
    step = make_moe_train_step(mesh, donate=False)
    losses = []
    for t in STEPS:
        state, loss, aux = step(state, jnp.asarray(t))
        losses.append((float(loss), float(aux)))
    return losses, np_tree(state.params), np_tree(state.opt_state[0].trace)


def test_dp2_ep2_steps_match_the_jax_mesh_train_step(gangs, jax_params,
                                                     jax_mesh_steps):
    got = gangs["dp2_ep2"].run(cases.moe_steps,
                               spec(jax_params, ROUTES[0], STEPS))
    losses, params, trace = jax_mesh_steps
    np.testing.assert_allclose(list(zip(got["losses"], got["auxes"])),
                               losses, rtol=STEP_TOL, atol=STEP_TOL)
    assert_trees_close(got["params"], params, STEP_TOL, STEP_TOL)
    assert_trees_close(got["opt_state"]["trace"], trace, STEP_TOL, STEP_TOL)
    assert got["step"] == 3


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_steps_match_the_ports_one_device(gangs, jax_params,
                                               mesh_name):
    route = ROUTES[1]
    got = gangs[mesh_name].run(cases.moe_steps,
                               spec(jax_params, route, STEPS))
    state = one_device(jax_params, route)
    want = [tuple(v.item() for v in moe_step(state, torch.from_numpy(t)))
            for t in STEPS]
    np.testing.assert_allclose(list(zip(got["losses"], got["auxes"])),
                               want, rtol=STEP_TOL, atol=STEP_TOL)
    params, opt_state = gather_state(state)
    assert_trees_close(got["params"],
                       tree_map(lambda t: t.numpy(), params),
                       STEP_TOL, STEP_TOL)
    assert_trees_close(got["opt_state"]["trace"],
                       tree_map(lambda t: t.numpy(), opt_state["trace"]),
                       STEP_TOL, STEP_TOL)


def test_expert_axis_collectives_forward_and_backward(gangs):
    """Rank r's input is ``base + 100 r`` and its upstream gradient
    ``r + 1``: over ``"expert"`` (ranks {0, 1} and {2, 3} of the 2 x 2
    mesh) *f* is the identity forward and sums the gradient, *g* sums
    forward and passes the gradient, ``psum`` sums both ways; over
    ``"data"`` (ranks {0, 2} and {1, 3}) ``psum`` likewise."""
    every = gangs["dp2_ep2"].run(cases.moe_collectives)
    base = np.arange(6, dtype=np.float64).reshape(2, 3)
    for r, out in enumerate(every):
        d, e = r // 2, r % 2
        assert out["coords"] == {"data": d, "expert": e}
        expert_peers = [2 * d, 2 * d + 1]
        data_peers = [e, 2 + e]
        x = base + 100.0 * r
        ones = np.ones_like(base)

        def total(peers):
            return sum(base + 100.0 * p for p in peers)

        def grads(peers):
            return ones * sum(p + 1 for p in peers)

        y, g = out["copy_expert"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_array_equal(g, grads(expert_peers))
        y, g = out["reduce_expert"]
        np.testing.assert_array_equal(y, total(expert_peers))
        np.testing.assert_array_equal(g, ones * (r + 1))
        y, g = out["psum_expert"]
        np.testing.assert_array_equal(y, total(expert_peers))
        np.testing.assert_array_equal(g, grads(expert_peers))
        y, g = out["psum_data"]
        np.testing.assert_array_equal(y, total(data_peers))
        np.testing.assert_array_equal(g, grads(data_peers))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_place_moe_keeps_each_ranks_experts(jax_params, mesh_name):
    """Each rank's leaves are its slices of the whole tree, by
    ``MOE_EP_RULES`` or, with a ``"model"`` axis, ``MOE_EP_TP_RULES``:
    the experts' dim 0 over ``"expert"``, ``w_up``'s dim 2 and
    ``w_down``'s dim 1 over ``"model"`` (and the attention, embeddings
    and head by the transformer rules); the router whole; the momentum
    cut alike."""
    axes = MESHES[mesh_name]
    whole = params_from_numpy(np_tree(jax_params))
    trace = tree_map(lambda t: t + 1.0, whole)
    rules = MOE_EP_TP_RULES if "model" in axes else MOE_EP_RULES
    assert shard_dims("layer0/moe_mlp/w_up", rules) == (
        {"expert": 0, "model": 2} if "model" in axes else {"expert": 0})
    assert shard_dims("layer0/moe_mlp/router/kernel", rules) == {}
    for rank in range(4):
        mesh = Mesh(size=4, rank=rank, device=torch.device("cpu"),
                    backend="gloo", axis_names=tuple(axes),
                    axis_sizes=tuple(axes.values()))
        model = MoeTransformerLM(dtype=torch.float32, mesh=mesh, **CFG)
        assert model.shard_rules is rules
        state = place_moe(model, whole, opt_state={"trace": trace})
        e = mesh.coord("expert")
        m = mesh.coord("model")
        got = dict(leaves(tree_map(lambda t: t.detach(), state.params)))
        mom = {f"{n.replace('.', '/')}": state.opt.state[p][
            "momentum_buffer"].numpy() for n, p in model.named_parameters()}
        for path, w in leaves(whole):
            want = w
            dims = shard_dims(path, rules)
            for axis, dim in dims.items():
                n = axes[axis]
                k = want.shape[dim] // n
                idx = [slice(None)] * want.ndim
                c = e if axis == "expert" else m
                idx[dim] = slice(c * k, (c + 1) * k)
                want = want[tuple(idx)]
            np.testing.assert_array_equal(got[path], want, err_msg=path)
            np.testing.assert_array_equal(mom[path], want + 1.0,
                                          err_msg=path)
        up = got["layer0/moe_mlp/w_up"]
        assert up.shape == (2, 32, 128 // axes.get("model", 1))


def test_every_rank_of_a_data_shard_draws_the_same_rows(monkeypatch):
    """Ranks that differ only along ``"expert"`` or ``"model"`` draw the
    same bytes, JAX's for their data shard."""
    axes = {"data": 2, "expert": 2, "model": 2}
    jax_mesh = jax_device_mesh(axes, devices=jax.devices()[:8])
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    rows = {}
    for rank in range(8):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        mesh = Mesh(size=8, rank=rank, device=torch.device("cpu"),
                    backend="gloo", axis_names=tuple(axes),
                    axis_sizes=tuple(axes.values()))
        got = next(synthetic_token_batches_for_mesh(8, SEQ + 1, 64, mesh))
        want = next(jax_batches_for_mesh(8, SEQ + 1, 64, jax_mesh))
        np.testing.assert_array_equal(got, want)
        rows.setdefault(mesh.coord("data"), []).append(got)
    for shard in rows.values():
        assert all(np.array_equal(shard[0], r) for r in shard)
    assert not np.array_equal(rows[0][0], rows[1][0])


MOE_TINY = ["--model", "moe", "--vocab", "64", "--hidden", "32", "--heads",
            "4", "--layers", "2", "--seq", "16", "--batch-per-chip", "2",
            "--steps", "3", "--device", "cpu"]


def run_worker(*extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker", *MOE_TINY,
         *extra], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("extra,mesh_line", [
    (["--ep", "2", "--cpu-ranks", "2"],
     "data=1 expert=2 model=1 devices=cpu,cpu"),
    (["--ep", "2", "--tp", "2", "--cpu-ranks", "4"],
     "data=1 expert=2 model=2 devices=cpu,cpu,cpu,cpu"),
    (["--ep", "2", "--cpu-ranks", "4", "--moe-router", "top2",
      "--moe-dispatch", "gather", "--num-experts", "4"],
     "data=2 expert=2 model=1 devices=cpu,cpu,cpu,cpu"),
], ids=["ep2", "ep2-tp2", "dp2-ep2-top2-gather"])
def test_moe_worker_trains_over_cpu_ranks(extra, mesh_line):
    out = run_worker(*extra)
    assert re.search(rf"^TRAINING_MESH {mesh_line} backend=gloo$", out,
                     re.M), out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    n = int(mesh_line.count("cpu"))
    for rank in range(n):
        assert re.search(rf"^K3_LAUNCHES flash_forward=0 steps=3 layers=2 "
                         rf"device=cpu rank={rank}$", out, re.M), out


def test_moe_worker_at_one_device_prints_its_lines():
    out = run_worker("--num-experts", "4", "--moe-router", "expert_choice")
    assert "TRAINING_MESH" not in out
    assert re.search(r"^steady_state tokens_per_sec=[\d.]+ loss=[\d.]+$",
                     out, re.M), out
    assert re.search(r"^FIRST_STEP_DONE seconds=[\d.]+ loss=[\d.]+$", out,
                     re.M), out


def test_moe_worker_mesh_trains_the_one_device_weights():
    """ep 2 over two ranks and one device with two experts draw one tree
    and one batch stream: the same first loss (bf16 compute, summed in
    another order over the mesh)."""
    one = worker.run_moe(worker.build_parser().parse_args(
        MOE_TINY + ["--num-experts", "2", "--steps", "2"]))
    mesh = worker.run_moe(worker.build_parser().parse_args(
        MOE_TINY + ["--ep", "2", "--cpu-ranks", "2", "--steps", "2"]))
    assert len(mesh["ranks"]) == 2 and mesh["mesh"] == {"data": 1,
                                                         "expert": 2}
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=2e-2)
    assert len(one["losses"]) == len(mesh["losses"]) == 2


@pytest.mark.parametrize("bad,match", [
    (["--ep", "3", "--cpu-ranks", "2"], "--ep 3 exceeds"),
    (["--ep", "3", "--cpu-ranks", "4"], "--ep 3 does not divide"),
    (["--tp", "3", "--cpu-ranks", "4"], "--tp 3 does not divide"),
    (["--tp", "8", "--cpu-ranks", "4"], "--tp 8 exceeds"),
    (["--tp", "2", "--cpu-ranks", "2", "--heads", "5", "--hidden", "40"],
     "--heads 5 not divisible by tp=2"),
    (["--ep", "2", "--cpu-ranks", "2", "--num-experts", "3"],
     "--num-experts 3 not divisible by ep=2"),
])
def test_moe_worker_refusals(bad, match):
    with pytest.raises(SystemExit, match=re.escape(match)):
        worker.main(MOE_TINY + bad)
