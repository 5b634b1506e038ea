"""The port's MoE transformer (``kubegpu_tpu_torch/models/moe.py``,
``models/train.py``'s ``moe_loss``/``moe_step``, ``models/params.py``'s
``init_moe_params``) against the JAX package's ``models/moe.py`` at
float32 and small widths, at one device: the same flax weights, carried
over with ``params_from_numpy``, and the same numpy inputs.

- ``MoEMLP``: every router (``top1``, ``top2``, ``expert_choice``) x
  dispatch (``einsum``, ``gather``) x ``fast_dispatch``, at capacity
  factor 2 and at 0.5 (overflow drops), and on tied gates (identical
  rows: the first argmax, the slot cumsum, ``top_k``'s lower index
  first): output within 1e-5, aux loss and drop rate within 1e-6; the
  gradients of a weighted sum of the output plus the aux loss within
  rtol=atol 1e-4.
- ``MoeTransformerLM`` logits within 1e-5 with einsum and with flash
  attention (JAX's flash through its interpret mode on the CPU, the
  port's through the kernels' plain twins).
- ``moe_loss``, its aux and every gradient leaf against JAX's
  ``value_and_grad`` (loss 1e-5; gradients rtol=atol 1e-4); three
  carried nesterov SGD steps against ``make_moe_train_step`` (losses,
  auxes, weights and momentum within 1e-5); ``remat`` equal to the
  plain step; ``moe_router_stats`` equal to JAX's.
- ``init_moe_params``: flax's tree, shapes and initializer families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models.moe import (
    MoEMLP as JaxMoEMLP,
    MoeTransformerLM as JaxMoeTransformerLM,
    moe_router_stats as jax_moe_router_stats,
)
from kubegpu_tpu.models.train import (
    create_train_state as jax_create_train_state,
    make_moe_train_step,
    moe_loss as jax_moe_loss,
    place_moe as jax_place_moe,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu_torch.models.moe import (
    MoEMLP,
    MoeTransformerLM,
    capacity_of,
    moe_router_stats,
)
from kubegpu_tpu_torch.models.params import (
    bind_params,
    init_moe_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.models.train import (
    create_train_state,
    grad_tree,
    moe_grads,
    moe_step,
    momentum_tree,
    train_state_from_numpy,
)
from kubegpu_tpu_torch.parallel.mesh import Mesh

D, E = 8, 4
X_SHAPE = (2, 16, D)
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=49,
           num_experts=E)
BATCH, SEQ = 3, 48
OUT_TOL = 1e-5
STAT_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
ROUTES = [("top1", "einsum"), ("top1", "gather"), ("top2", "einsum"),
          ("top2", "gather"), ("expert_choice", "einsum")]


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


def x_np(tied=False):
    x = np.random.RandomState(0).randn(*X_SHAPE).astype(np.float32)
    if tied:
        x[1] = x[1, :1]   # every token of row 1 the same: tied gates
    return x


def tokens_np(seed):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


def layer_pair(router, dispatch, fast=True, cf=2.0):
    jl = JaxMoEMLP(num_experts=E, capacity_factor=cf, dtype=jnp.float32,
                   router_type=router, fast_dispatch=fast,
                   dispatch_impl=dispatch)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x_np()))["params"]
    tl = bind_params(
        MoEMLP(D, E, capacity_factor=cf, dtype=torch.float32,
               router_type=router, fast_dispatch=fast,
               dispatch_impl=dispatch),
        params_from_numpy(np_tree(params)))
    return jl, params, tl


def jax_layer_out(jl, params, x):
    out, mut = jl.apply({"params": params}, jnp.asarray(x),
                        mutable=["intermediates"])
    inter = mut["intermediates"]
    return (np.asarray(out), float(inter["aux_loss"][0]),
            float(inter["drop_rate"][0]))


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["cf2", "overflow"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "f32"])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("router", ["top1", "top2", "expert_choice"])
def test_moe_mlp_matches_jax(router, dispatch, fast, cf):
    jl, params, tl = layer_pair(router, dispatch, fast, cf)
    x = x_np()
    want, aux_j, drop_j = jax_layer_out(jl, params, x)
    with torch.no_grad():
        out, aux, drop = tl(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == X_SHAPE
    np.testing.assert_allclose(out.numpy(), want, rtol=OUT_TOL, atol=OUT_TOL)
    assert abs(aux.item() - aux_j) <= STAT_TOL
    assert abs(drop.item() - drop_j) <= STAT_TOL
    if cf == 0.5 and router != "expert_choice":
        assert drop_j > 0   # the overflow case does drop


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("router", ["top1", "top2", "expert_choice"])
def test_moe_mlp_on_tied_gates_matches_jax(router, dispatch):
    """Identical tokens tie every gate of their row: the first argmax,
    the cumsum's slot order and ``top_k``'s lower index first decide
    which tokens are kept, at capacity 0.5 and 2."""
    for cf in (0.5, 2.0):
        jl, params, tl = layer_pair(router, dispatch, cf=cf)
        x = x_np(tied=True)
        want, aux_j, drop_j = jax_layer_out(jl, params, x)
        with torch.no_grad():
            out, aux, drop = tl(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), want, rtol=OUT_TOL,
                                   atol=OUT_TOL)
        assert abs(aux.item() - aux_j) <= STAT_TOL
        assert abs(drop.item() - drop_j) <= STAT_TOL


@pytest.mark.parametrize("router,dispatch", ROUTES)
def test_moe_mlp_gradients_match_jax(router, dispatch):
    """The backward of one layer: the gradients of ``sum(out * r) +
    aux`` with respect to the router, both expert kernels and the
    input."""
    jl, params, tl = layer_pair(router, dispatch, cf=1.0)
    x = x_np()
    r = np.random.RandomState(3).randn(*X_SHAPE).astype(np.float32)

    def f(p, xx):
        out, mut = jl.apply({"params": p}, xx, mutable=["intermediates"])
        return (jnp.sum(out * jnp.asarray(r))
                + mut["intermediates"]["aux_loss"][0])

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    for p in tl.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux, _ = tl(xt)
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    got = {"router": {"kernel": tl.router.kernel.grad.numpy()},
           "w_up": tl.w_up.grad.numpy(), "w_down": tl.w_down.grad.numpy()}
    assert_trees_close(got, np_tree(gp), GRAD_TOL, GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_capacity_is_the_jax_expression():
    import math

    for s, e, cf in ((16, 4, 2.0), (16, 4, 0.5), (1024, 4, 2.0),
                     (7, 3, 1.25), (8, 16, 0.5), (5, 1, 4.0)):
        assert capacity_of(s, e, cf) == min(s, int(math.ceil(s * cf / e)))


def jax_model(router, dispatch, attn_impl, remat=False):
    return JaxMoeTransformerLM(dtype=jnp.float32, router_type=router,
                               dispatch_impl=dispatch, attn_impl=attn_impl,
                               remat=remat, **CFG)


def torch_model(router, dispatch, attn_impl, remat=False):
    return MoeTransformerLM(dtype=torch.float32, router_type=router,
                            dispatch_impl=dispatch, attn_impl=attn_impl,
                            remat=remat, **CFG)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX MoE train state (fresh flax init, optax nesterov SGD)."""
    return jax_create_train_state(
        jax_model("top1", "einsum", "einsum"), jax.random.PRNGKey(0),
        jnp.asarray(tokens_np(0))[:, :-1])


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
@pytest.mark.parametrize("router,dispatch", ROUTES)
def test_logits_match_the_jax_model(jax_state, router, dispatch, attn_impl):
    tokens = tokens_np(1)
    want = jax_model(router, dispatch, attn_impl).apply(
        {"params": jax_state.params}, jnp.asarray(tokens))
    model = bind_params(torch_model(router, dispatch, attn_impl),
                        params_from_numpy(np_tree(jax_state.params)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, SEQ + 1, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


def jax_loss_and_grads(jax_state, router, dispatch, attn_impl, tokens):
    state = jax_state.replace(
        apply_fn=jax_model(router, dispatch, attn_impl).apply)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, t: jax_moe_loss(state, p, t, 0.01), has_aux=True))(
        state.params, jnp.asarray(tokens))
    return float(loss), float(aux), np_tree(grads)


@pytest.mark.parametrize("router,dispatch,attn_impl", [
    r + (a,) for r, a in zip(ROUTES, ["einsum", "flash", "einsum", "flash",
                                      "flash"])])
def test_loss_aux_and_every_gradient_match_jax(jax_state, router, dispatch,
                                               attn_impl):
    tokens = tokens_np(2)
    loss_j, aux_j, grads_j = jax_loss_and_grads(jax_state, router, dispatch,
                                                attn_impl, tokens)
    state = create_train_state(torch_model(router, dispatch, attn_impl),
                               params_from_numpy(np_tree(jax_state.params)))
    loss, aux = moe_grads(state, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(aux.item(), aux_j, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert not aux.requires_grad
    assert_trees_close(grad_tree(state), grads_j, GRAD_TOL, GRAD_TOL)


@pytest.mark.parametrize("router,dispatch", [("top1", "einsum"),
                                             ("top2", "gather"),
                                             ("expert_choice", "einsum")])
def test_three_carried_sgd_steps_match_jax(jax_state, router, dispatch):
    """From a state already one step in (a non-zero momentum trace),
    three ``moe_step``s against JAX's ``make_moe_train_step`` on a
    one-device ``{"data": 1, "expert": 1}`` mesh."""
    mesh = jax_device_mesh({"data": 1, "expert": 1},
                           devices=jax.devices()[:1])
    state = jax_state.replace(
        apply_fn=jax_model(router, dispatch, "einsum").apply)
    batches = [jnp.asarray(tokens_np(10 + i)) for i in range(4)]
    state, _ = jax_place_moe(state, batches[0], mesh)
    step = make_moe_train_step(mesh, donate=False)
    state, _, _ = step(state, batches[0])
    start = np_tree(state.params), np_tree(state.opt_state[0].trace)
    want = []
    for t in batches[1:]:
        state, loss, aux = step(state, t)
        want.append((float(loss), float(aux)))
    ts = train_state_from_numpy(torch_model(router, dispatch, "einsum"),
                                start[0], start[1], step=1, device="cpu")
    got = [tuple(v.item() for v in moe_step(ts, torch.from_numpy(
        np.array(t)))) for t in batches[1:]]
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    assert_trees_close(tree_map(lambda t: t.detach().numpy(), ts.params),
                       np_tree(state.params), STEP_TOL, STEP_TOL)
    assert_trees_close(momentum_tree(ts), np_tree(state.opt_state[0].trace),
                       STEP_TOL, STEP_TOL)
    assert ts.step == 4


@pytest.mark.parametrize("router,dispatch", [("top1", "einsum"),
                                             ("top2", "gather")])
def test_remat_equals_the_plain_step(jax_state, router, dispatch):
    """``remat=True`` recomputes each block in the backward: the same
    loss, aux and gradients bit for bit, each layer's aux counted once."""
    tokens = torch.from_numpy(tokens_np(4))
    got = []
    for remat in (False, True):
        state = create_train_state(
            torch_model(router, dispatch, "flash", remat=remat),
            params_from_numpy(np_tree(jax_state.params)))
        loss, aux = moe_grads(state, tokens)
        got.append((loss, aux, dict(leaves(grad_tree(state)))))
    (l0, a0, g0), (l1, a1, g1) = got
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for path in g0:
        np.testing.assert_array_equal(g1[path], g0[path], err_msg=path)


@pytest.mark.parametrize("router,dispatch", ROUTES)
def test_router_stats_match_jax(jax_state, router, dispatch):
    tokens = tokens_np(5)[:, :-1]
    aux_j, drop_j = jax_moe_router_stats(
        jax_model(router, dispatch, "einsum"), jax_state.params,
        jnp.asarray(tokens))
    model = bind_params(torch_model(router, dispatch, "einsum"),
                        params_from_numpy(np_tree(jax_state.params)))
    aux, drop = moe_router_stats(model, torch.from_numpy(tokens))
    assert abs(aux.item() - float(aux_j)) <= STAT_TOL
    assert abs(drop.item() - float(drop_j)) <= STAT_TOL
    assert 0.0 <= drop.item() < 1.0


def test_init_moe_params_has_the_flax_tree_and_distributions(jax_state):
    cfg = dict(CFG, hidden=64, num_experts=8)
    cfg.pop("num_heads")
    tree = init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = dict(leaves(np_tree(jax_state.params)))
    got = dict(leaves(tree))
    assert got.keys() == want.keys()
    layer = tree["layer0"]["moe_mlp"]
    d, e, h = 64, 8, 256
    assert layer["router"]["kernel"].shape == (d, e)
    assert layer["w_up"].shape == (e, d, h)
    assert layer["w_down"].shape == (e, h, d)
    for name, fan_in in (("w_up", d), ("w_down", h)):
        w = layer[name]
        std = 1.0 / np.sqrt(fan_in)
        # flax's truncated normal: std 1/sqrt(fan_in) after truncation
        # at 2 of the underlying std
        assert abs(w.std().item() / std - 1.0) < 0.05, name
        assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6
        # each expert's matrix drawn on its own (not one shared draw)
        assert not torch.equal(w[0], w[1])
    assert all(v.dtype == np.float32 for v in got.values())
    # another seed, other weights
    other = init_moe_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert not torch.equal(other["layer0"]["moe_mlp"]["w_up"],
                           layer["w_up"])


def test_bad_router_dispatch_and_meshes_are_refused():
    with pytest.raises(ValueError, match="router_type"):
        MoEMLP(D, E, router_type="top3")
    with pytest.raises(ValueError, match="dispatch_impl"):
        MoEMLP(D, E, dispatch_impl="scatter")
    ep_mesh = Mesh(size=4, rank=0, device=torch.device("cpu"),
                   backend="gloo", axis_names=("data", "expert"),
                   axis_sizes=(1, 4))
    with pytest.raises(ValueError, match="num_experts 2 does not divide"):
        MoEMLP(D, 2, mesh=ep_mesh)
    seq_mesh = Mesh(size=2, rank=0, device=torch.device("cpu"),
                    backend="gloo", axis_names=("data", "seq"),
                    axis_sizes=(1, 2))
    with pytest.raises(ValueError, match="trains over"):
        MoeTransformerLM(mesh=seq_mesh, **CFG)
    tp_mesh = Mesh(size=4, rank=0, device=torch.device("cpu"),
                   backend="gloo", axis_names=("data", "expert", "model"),
                   axis_sizes=(1, 1, 4))
    with pytest.raises(ValueError, match="num_heads 2 does not divide"):
        MoeTransformerLM(mesh=tp_mesh, **dict(CFG, num_heads=2))
