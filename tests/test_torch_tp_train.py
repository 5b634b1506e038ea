"""Data x tensor-parallel LM training in the port (``TransformerLM(mesh=
...)``, ``models/train.py``, ``parallel/collectives.py``) against the JAX
package's ``make_lm_train_step`` on a ``{"data": 2, "model": 2}`` mesh.

The port's dp 2 x tp 2 step runs in one gang of four JAX-free processes
over gloo on the CPU (``parallel.launch.Gang``, rank bodies in
``tests/torch_tp_cases.py``), started once for the module; JAX's runs
here on four of the 8 CPU devices of ``tests/conftest.py``, with
sequence parallelism, from the same flax weights at float32.

- One step's loss within 1e-5 and every gradient leaf, gathered whole,
  within rtol 1e-4 and atol 1e-6 (``tests/test_torch_train.py``'s
  tolerances) of JAX's, for ``einsum`` and ``flash`` attention, and of
  the port's one-device step (also without sequence parallelism, where
  Megatron's *f* and *g* surround each pair of matmuls).
- Three steps from a carried state with a non-zero momentum trace:
  losses, weights and momentum within 1e-5 of JAX's.
- ``remat=True`` equals ``remat=False`` bit for bit.
- Under sequence parallelism each rank's LayerNorm gradients cover its
  own rows only: their sum over ``"model"`` (then the mean over
  ``"data"``) is what ``sync_grads`` leaves, and no rank's own is.
- Each autograd collective's forward and backward on every rank, the
  mesh's layout (rank r at data ``r // 2``, model ``r % 2``) and groups.
- ``synthetic_token_batches_for_mesh`` draws JAX's rows byte for byte
  at every data coordinate.
- ``train_state_from_numpy(..., mesh=...)`` keeps each rank's shard of
  the weights and of the momentum trace.
- The in-place serving collectives refuse a tensor that requires grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.data import (
    synthetic_token_batches_for_mesh as jax_batches_for_mesh,
)
from kubegpu_tpu.models.train import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_train_state,
    lm_loss as jax_lm_loss,
    make_lm_train_step,
    place_lm as jax_place_lm,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu.parallel.sharding import current_mesh
from kubegpu_tpu_torch.models.data import synthetic_token_batches_for_mesh
from kubegpu_tpu_torch.models.decoding import DecodeLM, _row_sum
from kubegpu_tpu_torch.models.params import (
    bind_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.models.train import (
    create_train_state,
    gather_state,
    grad_tree,
    lm_grads,
    lm_step,
    momentum_tree,
    train_state_from_numpy,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.parallel.collectives import all_gather, all_reduce_sum
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
from kubegpu_tpu_torch.parallel.sharding import shard_dim, shard_params
import torch_tp_cases as cases

AXES = {"data": 2, "model": 2}
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=33)
BATCH, SEQ = 4, 32
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
STEP_TOL = 1e-5
GANG_TIMEOUT_S = 300.0


def tokens_np(seed):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


def jax_model(attn_impl):
    return JaxTransformerLM(dtype=jnp.float32, attn_impl=attn_impl,
                            sequence_parallel=True, **CFG)


def jax_state(attn_impl, params):
    """A fresh JAX train state over ``params`` (the reference's optax
    nesterov SGD, a zero trace), built without another init."""
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={}, opt_state=tx.init(params),
                         apply_fn=jax_model(attn_impl).apply, tx=tx)


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
        jax_model("einsum"), jax.random.PRNGKey(0),
        jnp.asarray(tokens_np(0))[:, :-1]).params


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(AXES, str(tmp_path_factory.mktemp("dp2tp2")), backend="gloo",
             devices=["cpu"] * 4, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


@pytest.fixture(scope="module")
def port_grads(gang, jax_params):
    """The gang's one-step loss and whole gradients, by (attention,
    sequence parallelism, remat), computed once each."""
    cache = {}

    def get(attn_impl, sequence_parallel=True, remat=False):
        key = (attn_impl, sequence_parallel, remat)
        if key not in cache:
            cache[key] = gang.run(cases.train_grads, dict(
                params=np_tree(jax_params), cfg=CFG,
                model=dict(attn_impl=attn_impl, remat=remat,
                           sequence_parallel=sequence_parallel),
                tokens=[tokens_np(2)]))
        return cache[key]

    return get


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_dp2_tp2_loss_and_gradients_match_the_jax_2x2_mesh(
        jax_mesh, jax_params, port_grads, attn_impl):
    state, tokens = jax_place_lm(jax_state(attn_impl, jax_params),
                                 jnp.asarray(tokens_np(2)), jax_mesh)
    with current_mesh(jax_mesh):
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p, t: jax_lm_loss(state, p, t)))(state.params, tokens)
    got = port_grads(attn_impl)
    np.testing.assert_allclose(got["loss"], float(loss_j), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"], np_tree(grads_j), GRAD_RTOL, GRAD_ATOL)
    # the CPU takes the twins: no kernel launched
    assert not any(got["launches"].values())


def one_device_grads(jax_params, attn_impl):
    model = TransformerLM(dtype=torch.float32, attn_impl=attn_impl,
                          sequence_parallel=True, **CFG)
    state = create_train_state(model,
                               params_from_numpy(np_tree(jax_params)))
    loss = lm_grads(state, torch.from_numpy(tokens_np(2)))
    return loss.item(), tree_map(lambda t: t.numpy(), grad_tree(state))


@pytest.mark.parametrize("sequence_parallel", [True, False],
                         ids=["sp", "no-sp"])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_dp2_tp2_matches_the_ports_one_device_step(
        jax_params, port_grads, attn_impl, sequence_parallel):
    loss, grads = one_device_grads(jax_params, attn_impl)
    got = port_grads(attn_impl, sequence_parallel)
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"], grads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_remat_equals_no_remat_on_the_mesh(port_grads, attn_impl):
    a, b = port_grads(attn_impl), port_grads(attn_impl, remat=True)
    assert a["loss"] == b["loss"]
    for (pa, ga), (pb, gb) in zip(leaves(a["grads"]), leaves(b["grads"])):
        assert pa == pb and np.array_equal(ga, gb), pa


def test_three_carried_steps_match_make_lm_train_step(jax_mesh, jax_params,
                                                      gang):
    """One JAX step makes the momentum trace non-zero; the state is then
    carried across, sharded by the rules on each rank, and both sides
    take the same three steps on the 2 x 2 mesh."""
    batches = [jnp.asarray(tokens_np(10 + i)) for i in range(4)]
    state, _ = jax_place_lm(jax_state("flash", jax_params), batches[0],
                            jax_mesh)
    step = make_lm_train_step(jax_mesh, donate=False)
    state, _ = step(state, batches[0])
    got = gang.run(cases.train_steps, dict(
        params=np_tree(state.params), trace=np_tree(state.opt_state[0].trace),
        step=int(state.step), cfg=CFG,
        model=dict(attn_impl="flash", sequence_parallel=True),
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
    assert_trees_close(got["momentum"], np_tree(state.opt_state[0].trace),
                       STEP_TOL, STEP_TOL)


def test_three_steps_match_the_ports_one_device_steps(jax_params, gang):
    batches = [tokens_np(20 + i) for i in range(3)]
    got = gang.run(cases.train_steps, dict(
        params=np_tree(jax_params), cfg=CFG,
        model=dict(attn_impl="einsum", sequence_parallel=True),
        tokens=batches))
    model = TransformerLM(dtype=torch.float32, attn_impl="einsum", **CFG)
    state = create_train_state(model, params_from_numpy(np_tree(jax_params)))
    losses = [lm_step(state, torch.from_numpy(t)).item() for t in batches]
    params, opt_state = gather_state(state)
    moments = opt_state["trace"]
    np.testing.assert_allclose(got["losses"], losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert_trees_close(got["params"], tree_map(lambda t: t.numpy(), params),
                       STEP_TOL, STEP_TOL)
    assert_trees_close(got["momentum"],
                       tree_map(lambda t: t.numpy(), moments), STEP_TOL,
                       STEP_TOL)


def test_sequence_parallel_layernorm_gradients_need_their_model_sum(
        jax_params, gang):
    """Each rank differentiates its own s / tp rows of every LayerNorm:
    ``sync_grads`` sums them over "model" (step (a) of ``lm_step``) and
    averages over "data"; the result is the one-device gradient, which
    no rank's own gradient is."""
    every = gang.run(cases.layernorm_grads, dict(
        params=np_tree(jax_params), cfg=CFG,
        model=dict(attn_impl="flash", sequence_parallel=True),
        tokens=[tokens_np(2)]))
    _, want = one_device_grads(jax_params, "flash")
    names = list(every[0][2])
    # ln1 and ln2 of every layer and ln_f, a scale and a bias each
    assert len(names) == 4 * CFG["num_layers"] + 2
    for name in names:
        one = want
        for part in name.split("."):
            one = one[part]
        total = sum(before[name] for _, _, before, _ in every) / AXES["data"]
        for d, m, before, after in every:
            np.testing.assert_allclose(after[name], total, rtol=1e-5,
                                       atol=1e-7, err_msg=name)
            np.testing.assert_allclose(after[name], one, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
            # a rank's own share is not the gradient: step (a) is needed
            assert not np.allclose(before[name], one, rtol=1e-2,
                                   atol=1e-4), (name, d, m)


def test_autograd_collectives_forward_and_backward(gang):
    every = gang.run(cases.collective_grads)
    base = np.arange(24, dtype=np.float64).reshape(2, 4, 3)
    x = [base + 100.0 * r for r in range(4)]
    ones = np.ones_like(base)
    for r, got in enumerate(every):
        d, m = r // 2, r % 2
        row = [2 * d, 2 * d + 1]  # this rank's "model" group
        assert got["coords"] == (d, m)
        assert got["groups"] == {"data": [m, m + 2], "model": row}
        g_sum = sum(q + 1 for q in row)  # the group's summed upstream
        expect = {
            "copy_to_model": (x[r], g_sum * ones),
            "reduce_from_model": (x[row[0]] + x[row[1]], (r + 1) * ones),
            "gather_seq": (np.concatenate([x[q] for q in row], axis=1),
                           g_sum * ones),
            "scatter_seq": ((x[row[0]] + x[row[1]])[:, 2 * m:2 * m + 2],
                            np.concatenate([(q + 1) * ones[:, :2]
                                            for q in row], axis=1)),
            "split_seq": (x[r][:, 2 * m:2 * m + 2],
                          np.concatenate([(q + 1) * ones[:, :2]
                                          for q in row], axis=1)),
            "gather_hidden": (np.concatenate([x[q] for q in row], axis=-1),
                              (r + 1) * ones),
            "data_mean": ((x[m] + x[m + 2]) / 2, (r + 1) * ones),
        }
        for name, (y, gx) in expect.items():
            np.testing.assert_array_equal(got[name][0], y,
                                          err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(got[name][1], gx,
                                          err_msg=f"{name} grad rank {r}")


@pytest.mark.parametrize("seed", [0, 5])
def test_token_source_rows_equal_jax_for_every_data_coordinate(
        monkeypatch, jax_mesh, seed):
    """JAX draws one shard per local device; with one device a process
    (the port's layout) process d * tp + m draws data shard d."""
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    for rank in range(4):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        mesh = Mesh(size=4, rank=rank, device=torch.device("cpu"),
                    backend="gloo", axis_names=tuple(AXES),
                    axis_sizes=tuple(AXES.values()))
        want = jax_batches_for_mesh(8, SEQ + 1, 32768, jax_mesh, seed=seed)
        got = synthetic_token_batches_for_mesh(8, SEQ + 1, 32768, mesh,
                                               seed=seed)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.dtype == b.dtype == np.int32 and a.shape == (4, SEQ + 1)
            np.testing.assert_array_equal(a, b)
    # ranks of one data row draw the same rows, the two rows differ
    rows = [next(synthetic_token_batches_for_mesh(
        8, SEQ + 1, 32768, Mesh(size=4, rank=r, device=torch.device("cpu"),
                                backend="gloo", axis_names=tuple(AXES),
                                axis_sizes=tuple(AXES.values())), seed=seed))
            for r in range(4)]
    assert np.array_equal(rows[0], rows[1])
    assert np.array_equal(rows[2], rows[3])
    assert not np.array_equal(rows[0], rows[2])


def test_in_place_serving_collectives_refuse_tensors_that_require_grad(
        jax_params):
    """``_row_sum`` and the serving gathers run in-place collectives that
    autograd does not see: on a tensor that requires grad they raise
    before any collective runs (no process group exists here)."""
    mesh = Mesh(size=2, rank=0, device=torch.device("cpu"), backend="gloo")
    y = torch.ones((2, 3), requires_grad=True) * 2.0
    with pytest.raises(RuntimeError, match="autograd does not see"):
        _row_sum(y, mesh)
    with pytest.raises(RuntimeError, match="autograd does not see"):
        all_reduce_sum(y, mesh)
    with pytest.raises(RuntimeError, match="autograd does not see"):
        all_gather(y, mesh)
    # the serving model's embedding gather, with trainable weights bound
    tree = shard_params(params_from_numpy(np_tree(jax_params)), 0, 2)
    model = DecodeLM(dtype=torch.float32, mesh=mesh, **CFG)
    bind_params(model, tree, trainable=True)
    with pytest.raises(RuntimeError, match="autograd does not see"):
        model.embed_rows(torch.zeros((1, 2), dtype=torch.long),
                         torch.arange(2)[None])


def test_unsplittable_widths_are_refused():
    mesh = Mesh(size=4, rank=0, device=torch.device("cpu"), backend="gloo",
                axis_names=tuple(AXES), axis_sizes=tuple(AXES.values()))
    with pytest.raises(ValueError, match="num_heads 3"):
        TransformerLM(mesh=mesh, **dict(CFG, num_heads=3, hidden=30))
    with pytest.raises(ValueError, match="vocab_size 63"):
        TransformerLM(mesh=mesh, **dict(CFG, vocab_size=63))
    model = TransformerLM(mesh=mesh, sequence_parallel=True, **CFG)
    with pytest.raises(ValueError, match="sequence parallelism"):
        model(torch.zeros((1, 5), dtype=torch.long))


def test_train_state_from_numpy_keeps_each_ranks_shard_of_both_trees(
        jax_params):
    """``train_state_from_numpy(..., mesh=...)`` (``place_lm``) cuts the
    whole weights and the whole momentum trace by the same rules: every
    rank of a data row holds the same shards, and the "model" ranks'
    shards concatenate to the whole (no collective runs here)."""
    params = np_tree(jax_params)
    trace = jax.tree.map(lambda a: a * 0.5 + 1.0, params)
    shards = {}
    for rank in range(4):
        mesh = Mesh(size=4, rank=rank, device=torch.device("cpu"),
                    backend="gloo", axis_names=tuple(AXES),
                    axis_sizes=tuple(AXES.values()))
        state = train_state_from_numpy(
            TransformerLM(mesh=mesh, dtype=torch.float32, **CFG), params,
            trace, step=3)
        assert state.step == 3 and state.mesh is mesh
        shards[rank] = (dict(leaves(tree_map(lambda t: t.numpy(),
                                             state.params))),
                        dict(leaves(tree_map(lambda t: t.numpy(),
                                             momentum_tree(state)))))
    for (p0, m0), (p1, m1) in ((shards[0], shards[2]),
                               (shards[1], shards[3])):
        assert all(np.array_equal(p0[k], p1[k]) and
                   np.array_equal(m0[k], m1[k]) for k in p0)
    for path, whole in leaves(params):
        dim = shard_dim(path)
        for tree, got in ((whole, [shards[r][0][path] for r in (0, 1)]),
                          (dict(leaves(trace))[path],
                           [shards[r][1][path] for r in (0, 1)])):
            if dim is None:
                assert all(np.array_equal(g, tree) for g in got), path
            else:
                np.testing.assert_array_equal(
                    np.concatenate(got, axis=dim), tree, err_msg=path)
