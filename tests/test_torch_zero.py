"""ZeRO-1 in the port (``kubegpu_tpu_torch/parallel/zero.py``:
``zero1_state_shardings``, ``place_zero1_lm``,
``make_zero1_lm_train_step``, ``state_bytes_per_device``) against the
JAX package's ``kubegpu_tpu/parallel/zero.py`` at float32 with adam, at
``tests/test_zero.py``'s widths.

- The layout, without a gang: for ``{"data": 8}`` and ``{"data": 2}``
  (no rules) and ``{"data": 2, "model": 2}`` (``TRANSFORMER_TP_RULES``),
  sgd and adam, every optimizer-state leaf is laid out on the axis and
  dim of JAX's ``zero1_state_shardings`` spec, and rank 0's
  ``state_bytes_per_device`` (the tensors its placed state holds) equals
  JAX's.
- The trajectory, in a gloo gang on the CPU (rank bodies in
  ``tests/torch_zero_cases.py``): dp 2, and dp 2 x tp 2 with the TP
  rules, three adam steps: losses within rtol 1e-5 of JAX's
  ``make_zero1_lm_train_step`` (JAX's own gate, ``tests/test_zero.py``),
  the gathered weights and moments within 1e-5 of its state, the weights
  within 1e-6 of the port's plain data-parallel run, and each rank's
  moment bytes as JAX reckons them (at dp 2 half of the whole, but
  Adam's count).
- A ZeRO-1 checkpoint restores on one device equal to a plain run's
  checkpoint, and the two restore into each other's layout on the gang.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.train import TrainState as JaxTrainState
from kubegpu_tpu.parallel import (
    device_mesh as jax_device_mesh,
    make_zero1_lm_train_step as jax_zero1_step,
    place_zero1_lm as jax_place_zero1_lm,
    state_bytes_per_device as jax_state_bytes,
    zero1_state_shardings as jax_zero1_shardings,
)
from kubegpu_tpu.parallel.sharding import (
    TRANSFORMER_TP_RULES as JAX_TP_RULES,
    keypath_str,
)
from kubegpu_tpu_torch.models.checkpoint import (
    make_manager,
    restore_checkpoint,
)
from kubegpu_tpu_torch.models.params import (
    init_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    gather_state,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
from kubegpu_tpu_torch.parallel.sharding import TRANSFORMER_TP_RULES
from kubegpu_tpu_torch.parallel.zero import (
    place_zero1_lm,
    state_bytes_per_device,
    zero1_state_shardings,
)
import torch_zero_cases as cases

# tests/test_zero.py's CFG
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=33)
LR = 1e-3
BATCH = 4
STEPS = 3
LOSS_RTOL = 1e-5
STATE_TOL = 1e-5
REPLICATED_TOL = 1e-6
GANG_TIMEOUT_S = 300.0
MESHES = {"dp2": {"data": 2}, "dp2tp2": {"data": 2, "model": 2}}


def tokens_np(seed):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, CFG["max_seq"])).astype(np.int32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_close(got, want, tol):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=tol, atol=tol,
                                   err_msg=path)


def init_tree(seed=1):
    """Fresh weights at ``CFG`` as numpy, fed to both packages (the
    port's initializer: no JAX compile for an init)."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t.numpy(),
                    init_params(CFG, gen, torch.float32, "cpu"))


def jax_state(tx, params):
    params = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={}, opt_state=tx.init(params),
                         apply_fn=JaxTransformerLM(dtype=jnp.float32,
                                                   **CFG).apply, tx=tx)


def jax_opt_tree(opt_state):
    """optax's ``(ScaleByAdamState | TraceState, EmptyState)`` as the
    port's ``{"count", "mu", "nu"}`` / ``{"trace"}`` tree."""
    inner = opt_state[0]
    return {k: np_tree(getattr(inner, k)) for k in inner._fields}


def group_less_mesh(axes):
    """Rank 0 of ``axes`` as a :class:`Mesh` without process groups:
    enough to place a state (no collective runs)."""
    return Mesh(size=int(np.prod(list(axes.values()))), rank=0,
                device=torch.device("cpu"), backend="gloo",
                axis_names=tuple(axes),
                axis_sizes=tuple(axes.values()) if len(axes) > 1 else ())


def jax_tx(opt_name):
    return (optax.adam(LR) if opt_name == "adam"
            else optax.sgd(0.1, momentum=0.9, nesterov=True))


@pytest.fixture(scope="module")
def jax_params():
    return init_tree()


@pytest.fixture(scope="module")
def jax_states(jax_params):
    """A fresh JAX train state a optimizer, on the same weights."""
    return {name: jax_state(jax_tx(name), jax_params)
            for name in ("sgd", "adam")}


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("axes, tp_rules", [
    ({"data": 8}, False), ({"data": 2}, False),
    ({"data": 2, "model": 2}, True)], ids=["data8", "data2", "data2model2"])
def test_layout_and_bytes_match_jax_zero1_state_shardings(
        jax_states, jax_params, gangs, axes, tp_rules, opt_name):
    optimizer = adam(LR) if opt_name == "adam" else sgd()
    n = int(np.prod(list(axes.values())))
    mesh_j = jax_device_mesh(axes, devices=jax.devices()[:n])
    state_j = jax_states[opt_name]
    sh_j = jax_zero1_shardings(state_j, mesh_j,
                               JAX_TP_RULES if tp_rules else None)
    want = {keypath_str(kp).split("/", 1)[1]: tuple(s.spec)
            for kp, s in jax.tree_util.tree_flatten_with_path(
                sh_j.opt_state)[0]}
    mesh = group_less_mesh(axes)
    rules = TRANSFORMER_TP_RULES if tp_rules else None
    params = params_from_numpy(jax_params)
    sh = zero1_state_shardings(params, mesh, rules, optimizer)
    got = dict(leaves_of(sh["opt_state"]))
    assert got == want
    # some leaf really is cut over "data" on every mesh
    assert any("data" in spec for spec in got.values())
    state, _ = place_zero1_lm(TransformerLM(mesh=mesh, dtype=torch.float32,
                                            **CFG),
                              params, optimizer=optimizer)
    assert state_bytes_per_device(state) == jax_state_bytes(state_j, sh_j)


def leaves_of(layout, prefix=""):
    """The leaves of a layout tree (specs, tuples), by path."""
    for k, v in layout.items():
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    out = {}
    for name, axes in MESHES.items():
        n = int(np.prod(list(axes.values())))
        # the ranks boot while the layout tests run
        out[name] = Gang(axes, str(tmp_path_factory.mktemp(name)),
                         backend="gloo", devices=["cpu"] * n,
                         timeout_s=GANG_TIMEOUT_S).start()
    yield out
    for g in out.values():
        g.close()


@pytest.fixture(scope="module")
def runs(gangs, jax_params, tmp_path_factory):
    """Each mesh's three adam steps, ZeRO-1 and plain, each saving a
    checkpoint, run once."""
    batches = [tokens_np(10 + i) for i in range(STEPS)]
    out = {}
    for name, gang in gangs.items():
        for zero1 in (True, False):
            root = tmp_path_factory.mktemp(f"{name}-{zero1}")
            out[name, zero1] = gang.run(cases.zero1_run, dict(
                params=jax_params, cfg=CFG, optimizer=adam(LR), zero1=zero1,
                tokens=batches, dir=str(root)))
            out[name, zero1]["dir"] = str(root)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_three_adam_steps_match_jax_zero1_and_plain_dp(runs, jax_states,
                                                       mesh_name):
    axes = MESHES[mesh_name]
    n = int(np.prod(list(axes.values())))
    mesh = jax_device_mesh(axes, devices=jax.devices()[:n])
    state = jax_states["adam"]
    rules = JAX_TP_RULES if "model" in axes else None
    state, _, sh = jax_place_zero1_lm(state, jnp.asarray(tokens_np(10)),
                                      mesh, rules)
    step = jax_zero1_step(mesh, sh, donate=False)
    losses = []
    for i in range(STEPS):
        tok = jax.device_put(jnp.asarray(tokens_np(10 + i)),
                             jax.sharding.NamedSharding(
                                 mesh, jax.sharding.PartitionSpec("data")))
        state, loss = step(state, tok)
        losses.append(float(loss))
    got, plain = runs[mesh_name, True], runs[mesh_name, False]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert got["step"] == STEPS
    assert_trees_close(got["params"], np_tree(state.params), STATE_TOL)
    assert_trees_close(got["opt_state"], jax_opt_tree(state.opt_state),
                       STATE_TOL)
    assert_trees_close(got["params"], plain["params"], REPLICATED_TOL)
    # each rank holds what JAX reckons a device holds; over "data" alone
    # that is half of the whole moments, but Adam's 4-byte count
    want = jax_state_bytes(state, sh)
    assert got["bytes"] == [want] * n
    whole = sum(a.nbytes for _, a in leaves(got["opt_state"])
                if a.ndim)
    if mesh_name == "dp2":
        assert want[1] == whole // 2 + 4
    assert all(b[1] < p[1] for b, p in zip(got["bytes"], plain["bytes"]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_zero1_checkpoint_restores_on_one_device_as_a_plain_one(
        runs, jax_params, mesh_name):
    def restored(directory):
        model = TransformerLM(dtype=torch.float32, **CFG)
        state = create_train_state(model, params_from_numpy(jax_params),
                                   optimizer=adam(LR))
        restore_checkpoint(make_manager(directory), state)
        params, opt = gather_state(state)
        return (state.step,
                {k: v.numpy() for k, v in leaves_torch(params)},
                {k: v.numpy() for k, v in leaves_torch(opt)})

    z_step, z_params, z_opt = restored(runs[mesh_name, True]["dir"])
    p_step, p_params, p_opt = restored(runs[mesh_name, False]["dir"])
    assert z_step == p_step == STEPS
    assert z_params.keys() == p_params.keys()
    assert z_opt.keys() == p_opt.keys()
    for k in z_params:
        np.testing.assert_allclose(z_params[k], p_params[k],
                                   rtol=REPLICATED_TOL, atol=REPLICATED_TOL,
                                   err_msg=k)
    for k in z_opt:
        np.testing.assert_allclose(z_opt[k], p_opt[k], rtol=REPLICATED_TOL,
                                   atol=REPLICATED_TOL, err_msg=k)
    # the whole ZeRO-1 state was saved, equal to its gathered trees
    assert_trees_close(unflat(z_params), runs[mesh_name, True]["params"], 0)
    assert_trees_close(unflat(z_opt), runs[mesh_name, True]["opt_state"], 0)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_checkpoints_cross_between_zero1_and_plain_gangs(gangs, runs,
                                                         jax_params,
                                                         mesh_name):
    """A plain run's checkpoint restores into a ZeRO-1 state, and a
    ZeRO-1 run's into a plain one; both then take the same step."""
    batch = [tokens_np(20)]
    into_zero1 = gangs[mesh_name].run(cases.zero1_restore, dict(
        params=jax_params, cfg=CFG, optimizer=adam(LR), zero1=True,
        dir=runs[mesh_name, False]["dir"], tokens=batch))
    into_plain = gangs[mesh_name].run(cases.zero1_restore, dict(
        params=jax_params, cfg=CFG, optimizer=adam(LR), zero1=False,
        dir=runs[mesh_name, True]["dir"], tokens=batch))
    for got, src in ((into_zero1, runs[mesh_name, False]),
                     (into_plain, runs[mesh_name, True])):
        assert got["restored"]["step"] == STEPS
        assert_trees_close(got["restored"]["params"], src["params"], 0)
        assert_trees_close(got["restored"]["opt_state"], src["opt_state"], 0)
    np.testing.assert_allclose(into_zero1["loss"], into_plain["loss"],
                               rtol=REPLICATED_TOL)
    assert_trees_close(into_zero1["params"], into_plain["params"],
                       REPLICATED_TOL)
    assert_trees_close(into_zero1["opt_state"], into_plain["opt_state"],
                       REPLICATED_TOL)


def leaves_torch(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_torch(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out
