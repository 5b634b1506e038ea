"""The port's training path (kubegpu_tpu_torch/models/transformer.py,
train.py, data.py) against the JAX package at float32 and small widths:
the same flax weights, carried over with ``params_from_numpy``, and the
same tokens give the same logits, loss and gradients, and three steps
from a carried-over train state (``train_state_from_numpy``, optax's
momentum trace included) give the same losses, weights and momentum.

Tolerances: logits 1e-5 and train steps 1e-5 (two float32
implementations that differ only in summation order); gradients rtol
1e-4, atol 1e-6 (the flash backward's own tolerance, tests/test_ops.py;
embedding gradients scatter-add in another order); bf16 loss 5e-3
(measured below)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.data import synthetic_token_batches_for_mesh
from kubegpu_tpu.models.train import (
    create_train_state as jax_create_train_state,
    lm_loss as jax_lm_loss,
    make_lm_train_step,
    place_lm,
)
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu_torch.models.data import synthetic_token_batches
from kubegpu_tpu_torch.models.params import bind_params, params_from_numpy
from kubegpu_tpu_torch.models.train import (
    create_train_state,
    lm_loss,
    lm_step,
    momentum_tree,
    train_state_from_numpy,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=49)
SEQ = 48
BATCH = 3
LOGIT_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
STEP_TOL = 1e-5
# bf16 compute over float32 weights: the two frameworks round the bf16
# GEMMs, the embedding cast and the attention at different places.  Over
# three batches and both attention paths the losses (~4.6) measured
# 2.3e-4 to 2.0e-3 apart, as far as either lies from the float32 loss
# (up to 1.5e-3); the bound is 2.5x the widest gap
BF16_LOSS_TOL = 5e-3


def tokens_np(seed=0, batch=BATCH):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(batch, SEQ + 1)).astype(np.int32)


def jax_model(attn_impl, dtype=jnp.float32, remat=False):
    return JaxTransformerLM(dtype=dtype, attn_impl=attn_impl, remat=remat,
                            sequence_parallel=True, **CFG)


def torch_model(attn_impl, dtype=torch.float32, remat=False):
    return TransformerLM(dtype=dtype, attn_impl=attn_impl, remat=remat,
                         sequence_parallel=True, **CFG)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state (fresh flax init, optax nesterov SGD)."""
    tokens = jnp.asarray(tokens_np())
    return jax_create_train_state(jax_model("flash"), jax.random.PRNGKey(0),
                                  tokens[:, :-1])


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_by_path(jax_tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        yield ".".join(k.key for k in path), np.asarray(leaf)


def lookup(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_logits_match_the_jax_model(jax_state, attn_impl):
    tokens = tokens_np(1)
    want = jax_model(attn_impl).apply({"params": jax_state.params},
                                      jnp.asarray(tokens))
    model = bind_params(torch_model(attn_impl),
                        params_from_numpy(np_tree(jax_state.params)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, SEQ + 1, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_loss_and_every_gradient_match_jax(jax_state, attn_impl):
    tokens = tokens_np(2)
    state = jax_state.replace(apply_fn=jax_model(attn_impl).apply)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, t: jax_lm_loss(state, p, t)))(state.params,
                                                jnp.asarray(tokens))
    ts = create_train_state(torch_model(attn_impl),
                            params_from_numpy(np_tree(jax_state.params)))
    loss = lm_loss(ts.model, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    n = 0
    for path, want in leaves_by_path(grads_j):
        grad = ts.model.get_parameter(path).grad
        assert grad.dtype == torch.float32, path
        np.testing.assert_allclose(grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)
        n += 1
    assert n == len(list(ts.model.parameters()))


def test_three_steps_from_a_carried_state_match_make_lm_train_step():
    """One JAX step makes the momentum trace non-zero; the state is then
    carried across and both sides take the same three steps."""
    batches = [jnp.asarray(tokens_np(10 + i)) for i in range(4)]
    mesh = device_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    state = jax_create_train_state(jax_model("flash"), jax.random.PRNGKey(1),
                                   batches[0][:, :-1])
    state, _ = place_lm(state, batches[0], mesh)
    step = make_lm_train_step(mesh, donate=False)
    state, _ = step(state, batches[0])
    ts = train_state_from_numpy(torch_model("flash"), np_tree(state.params),
                                np_tree(state.opt_state[0].trace),
                                step=int(state.step), device="cpu")
    for tokens in batches[1:]:
        state, loss_j = step(state, tokens)
        loss = lm_step(ts, torch.from_numpy(np.array(tokens)))
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert ts.step == int(state.step) == 4
    moments = momentum_tree(ts)
    for path, want in leaves_by_path(state.params):
        np.testing.assert_allclose(lookup(ts.params, path).numpy(), want,
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=path)
        # the optimizer stepped the bound tree itself
        assert lookup(ts.params, path).data_ptr() == (
            ts.model.get_parameter(path).data_ptr())
    for path, want in leaves_by_path(state.opt_state[0].trace):
        np.testing.assert_allclose(lookup(moments, path).numpy(), want,
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=path)


def test_torch_nesterov_sgd_is_optax_sgd():
    """The optimizer mapping on its own: five updates of one tensor from
    a zero trace and from a carried one."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) for _ in range(5)]
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    for trace0 in (None, rng.randn(7, 5).astype(np.float32)):
        pj = jnp.asarray(p0)
        opt_state = tx.init(pj)
        if trace0 is not None:
            opt_state = (opt_state[0]._replace(trace=jnp.asarray(trace0)),
                         *opt_state[1:])
        pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = torch.optim.SGD([pt], lr=0.1, momentum=0.9, nesterov=True)
        if trace0 is not None:
            opt.state[pt]["momentum_buffer"] = torch.from_numpy(trace0.copy())
        for g in grads:
            updates, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
            pj = optax.apply_updates(pj, updates)
            pt.grad = torch.from_numpy(g.copy())
            opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(opt.state[pt]["momentum_buffer"].numpy(),
                                   np.asarray(opt_state[0].trace), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_remat_equals_no_remat(jax_state, attn_impl):
    tokens = torch.from_numpy(tokens_np(4))
    results = []
    for remat in (False, True):
        ts = create_train_state(torch_model(attn_impl, remat=remat),
                                params_from_numpy(np_tree(jax_state.params)))
        loss = lm_loss(ts.model, tokens)
        loss.backward()
        results.append((loss.detach(),
                        [p.grad for p in ts.model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_token_source_is_the_jax_one_device_source(monkeypatch):
    """On one device the JAX source is one data shard seeded
    SeedSequence([seed, 0]); the port draws the same bits."""
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    mesh = device_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    for seed in (0, 5):
        want = synthetic_token_batches_for_mesh(4, SEQ + 1, 32768, mesh,
                                                seed=seed)
        got = synthetic_token_batches(4, SEQ + 1, 32768, seed=seed)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_bf16_loss_is_close_to_the_jax_loss(jax_state, attn_impl):
    tokens = tokens_np(5)
    state = jax_state.replace(apply_fn=jax_model(attn_impl, jnp.bfloat16).apply)
    want = float(jax.jit(lambda p, t: jax_lm_loss(state, p, t))(
        jax_state.params, jnp.asarray(tokens)))
    ts = create_train_state(torch_model(attn_impl, torch.bfloat16),
                            params_from_numpy(np_tree(jax_state.params)))
    loss = lm_loss(ts.model, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - want) <= BF16_LOSS_TOL, (loss.item(), want)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in ts.model.parameters())


def test_trainable_binding_takes_float32_leaves_only(jax_state):
    tree = params_from_numpy(np_tree(jax_state.params))
    frozen = bind_params(torch_model("flash"), tree)
    assert not any(p.requires_grad for p in frozen.parameters())
    bf16 = {k: v for k, v in tree.items()}
    bf16["ln_f"] = {k: v.to(torch.bfloat16) for k, v in tree["ln_f"].items()}
    with pytest.raises(ValueError, match="float32"):
        bind_params(torch_model("flash"), bf16, trainable=True)


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_context_parallel_attention_waits_for_its_slice(jax_state, attn_impl):
    """Context-parallel attention with no ``"seq"`` mesh axis runs flash,
    in JAX (``transformer.py:90``) as in the port: the loss and every
    gradient equal JAX's ``attn_impl`` model's with no mesh, and the
    port's flash model's bit for bit.  (The case kept its name from when
    the port refused these modes.)"""
    tokens = tokens_np(2)
    state = jax_state.replace(apply_fn=jax_model(attn_impl).apply)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, t: jax_lm_loss(state, p, t)))(state.params,
                                                jnp.asarray(tokens))
    runs = {}
    for impl in (attn_impl, "flash"):
        ts = create_train_state(torch_model(impl),
                                params_from_numpy(np_tree(jax_state.params)))
        loss = lm_loss(ts.model, torch.from_numpy(tokens))
        loss.backward()
        runs[impl] = (loss.item(), {n: p.grad for n, p in
                                    ts.model.named_parameters()})
    loss, grads = runs[attn_impl]
    np.testing.assert_allclose(loss, float(loss_j), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert loss == runs["flash"][0]
    for path, want in leaves_by_path(grads_j):
        np.testing.assert_allclose(grads[path].numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)
        assert torch.equal(grads[path], runs["flash"][1][path]), path
