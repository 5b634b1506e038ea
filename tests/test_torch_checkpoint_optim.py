"""The training pieces a checkpoint carries, against the JAX package on
the CPU at float32:

- Adam: ``train.adam`` (``torch.optim.Adam``) against ``optax.adam`` over
  five updates of one tensor, from a zero state and from a carried one
  (mu, nu, count); they round in another order, so rtol 1e-5 and, for
  weights near 0, atol 1e-6 (a ten-thousandth of one step at lr 1e-2;
  the widest gap measured 2.4e-7);
- a JAX train state (fresh flax init, one JAX step), saved by the JAX
  package's Orbax checkpoint and converted by
  ``tools/orbax_to_torch_checkpoint.py``, restored into the port and
  stepped three times: losses within 1e-5 of JAX's next three steps,
  weights and optimizer state rtol 1e-4, for SGD and for Adam;
- ``structured_token_batches`` bit for bit, over seeds, workers, branch
  probabilities and vocabularies;
- ``draft_distill_loss`` and its gradients within 1e-5 of JAX's at two
  temperatures, and one ``draft_distill_step`` against
  ``make_draft_distill_step``: the same loss and weights, and the
  teacher left untouched with no gradient."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.checkpoint import (
    make_manager as jax_make_manager,
    save_checkpoint as jax_save_checkpoint,
)
from kubegpu_tpu.models.data import (
    structured_token_batches as jax_structured_token_batches,
)
from kubegpu_tpu.models.train import (
    create_train_state as jax_create_train_state,
    draft_distill_loss as jax_draft_distill_loss,
    make_draft_distill_step,
    make_lm_train_step,
    place_lm,
)
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu_torch.models.checkpoint import (
    make_manager,
    restore_checkpoint,
)
from kubegpu_tpu_torch.models.data import structured_token_batches
from kubegpu_tpu_torch.models.params import (
    bind_params,
    init_params,
    params_from_numpy,
)
from kubegpu_tpu_torch.models.train import (
    adam,
    create_train_state,
    draft_distill_loss,
    draft_distill_step,
    lm_step,
    opt_state_tree,
    sgd,
)
from kubegpu_tpu_torch.models.transformer import TransformerLM

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import orbax_to_torch_checkpoint as converter  # noqa: E402

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=25)
DRAFT_CFG = dict(vocab_size=61, num_layers=1, num_heads=2, hidden=16,
                 max_seq=25)
SEQ = 24
STEP_TOL = 1e-5
STATE_RTOL = 1e-4
ADAM_RTOL = 1e-5
DISTILL_TOL = 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, np.asarray(v)


def tokens_np(seed, batch=3, vocab=61):
    return np.random.RandomState(seed).randint(
        0, vocab, size=(batch, SEQ + 1)).astype(np.int32)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_adam_is_optax_adam(carried):
    rng = np.random.RandomState(3)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) * 10 ** -i for i in range(5)]
    tx = optax.adam(1e-2)
    pj = jnp.asarray(p0)
    opt_state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam(lr=1e-2).build([pt])
    if carried:
        mu = rng.randn(7, 5).astype(np.float32) * 0.1
        nu = rng.rand(7, 5).astype(np.float32) * 0.01
        opt_state = (opt_state[0]._replace(
            count=jnp.asarray(4, jnp.int32), mu=jnp.asarray(mu),
            nu=jnp.asarray(nu)), *opt_state[1:])
        opt.state[pt].update(exp_avg=torch.from_numpy(mu.copy()),
                             exp_avg_sq=torch.from_numpy(nu.copy()),
                             step=torch.tensor(4.0))
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               rtol=ADAM_RTOL, atol=1e-6)
    st = opt.state[pt]
    np.testing.assert_allclose(st["exp_avg"].numpy(),
                               np.asarray(opt_state[0].mu), rtol=ADAM_RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                               np.asarray(opt_state[0].nu), rtol=ADAM_RTOL,
                               atol=1e-12)
    assert int(st["step"]) == int(opt_state[0].count)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_a_converted_jax_state_trains_on_as_jax_does(tmp_path, name):
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True) if name == "sgd" else (
        optax.adam(1e-2))
    optimizer = sgd() if name == "sgd" else adam(lr=1e-2)
    batches = [jnp.asarray(tokens_np(30 + i)) for i in range(4)]
    mesh = device_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    model = JaxTransformerLM(dtype=jnp.float32, attn_impl="einsum", **CFG)
    state = jax_create_train_state(model, jax.random.PRNGKey(1),
                                   batches[0][:, :-1], tx=tx)
    state, _ = place_lm(state, batches[0], mesh)
    step = make_lm_train_step(mesh, donate=False)
    state, _ = step(state, batches[0])
    mgr = jax_make_manager(str(tmp_path / "jax" / "lm"))
    assert jax_save_checkpoint(mgr, state) == 1
    mgr.wait_until_finished()
    converter.convert(str(tmp_path / "jax"), str(tmp_path / "port"))

    fresh = {k: v for k, v in CFG.items() if k != "num_heads"}
    ts = create_train_state(
        TransformerLM(dtype=torch.float32, attn_impl="einsum", **CFG),
        init_params(fresh, torch.Generator().manual_seed(9), torch.float32,
                    "cpu"), optimizer=optimizer)
    restore_checkpoint(make_manager(str(tmp_path / "port" / "lm")), ts)
    assert ts.step == 1
    for tokens in batches[1:]:
        state, loss_j = step(state, tokens)
        loss = lm_step(ts, torch.from_numpy(np.array(tokens)))
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert ts.step == int(state.step) == 4
    got_params = dict(leaves(_torch_tree(ts.params)))
    for path, want in leaves(np_tree(state.params)):
        np.testing.assert_allclose(got_params[path], want, rtol=STATE_RTOL,
                                   atol=1e-6, err_msg=path)
    got = opt_state_tree(ts)
    first = np_tree(state.opt_state[0])
    slots = ("trace",) if name == "sgd" else ("mu", "nu")
    for slot in slots:
        mine = dict(leaves(_torch_tree(got[slot])))
        for path, want in leaves(getattr(first, slot)):
            np.testing.assert_allclose(mine[path], want, rtol=STATE_RTOL,
                                       atol=1e-7, err_msg=f"{slot}/{path}")
    if name == "adam":
        assert int(got["count"]) == int(first.count) == 4


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            v.detach().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("kw", [
    dict(batch=3, seq_len=17, vocab_size=61, seed=0, worker_id=0),
    dict(batch=2, seq_len=33, vocab_size=32000, seed=5, worker_id=3),
    dict(batch=4, seq_len=9, vocab_size=97, seed=2, worker_id=1,
         branch_probs=(0.5, 0.3, 0.2)),
])
def test_structured_token_batches_are_the_jax_streams(kw):
    mine, ref = structured_token_batches(**kw), jax_structured_token_batches(
        **kw)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def distill():
    """A tiny target (teacher) and draft with flax weights, and rollout
    tokens."""
    teacher = JaxTransformerLM(dtype=jnp.float32, attn_impl="einsum", **CFG)
    draft = JaxTransformerLM(dtype=jnp.float32, attn_impl="einsum",
                             **DRAFT_CFG)
    tokens = jnp.asarray(tokens_np(7))
    t_params = teacher.init(jax.random.PRNGKey(2), tokens[:, :-1])["params"]
    d_state = jax_create_train_state(draft, jax.random.PRNGKey(3),
                                     tokens[:, :-1])
    return teacher, t_params, d_state, tokens


def torch_lm(cfg, params):
    return bind_params(TransformerLM(dtype=torch.float32, attn_impl="einsum",
                                     **cfg), params_from_numpy(np_tree(params)))


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_draft_distill_loss_and_gradients_match_jax(distill, temperature):
    teacher, t_params, d_state, tokens = distill
    t_logits = teacher.apply({"params": t_params}, tokens[:, :-1])
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_draft_distill_loss(d_state, p, tokens, t_logits,
                                         temperature=temperature))(
        d_state.params)
    state = create_train_state(
        TransformerLM(dtype=torch.float32, attn_impl="einsum", **DRAFT_CFG),
        params_from_numpy(np_tree(d_state.params)))
    teacher_logits = torch.from_numpy(np.array(t_logits)).requires_grad_()
    loss = draft_distill_loss(state.model, torch.from_numpy(
        np.array(tokens)), teacher_logits, temperature=temperature)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=DISTILL_TOL,
                               atol=DISTILL_TOL)
    assert teacher_logits.grad is None   # the teacher is frozen
    for path, want in leaves(np_tree(grads_j)):
        grad = state.model.get_parameter(path.replace("/", ".")).grad
        np.testing.assert_allclose(grad.numpy(), want, rtol=DISTILL_TOL,
                                   atol=DISTILL_TOL, err_msg=path)


def test_draft_distill_step_matches_make_draft_distill_step(distill):
    teacher, t_params, d_state, tokens = distill
    mesh = device_mesh({"data": 1}, devices=jax.devices()[:1])
    step = make_draft_distill_step(mesh, teacher.apply, temperature=1.5,
                                   donate=False)
    new_state, loss_j = step(d_state, t_params, tokens)
    state = create_train_state(
        TransformerLM(dtype=torch.float32, attn_impl="einsum", **DRAFT_CFG),
        params_from_numpy(np_tree(d_state.params)))
    t_model = torch_lm(CFG, t_params)
    before = {n: p.detach().clone() for n, p in t_model.named_parameters()}
    loss = draft_distill_step(state, t_model, torch.from_numpy(
        np.array(tokens)), temperature=1.5)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=DISTILL_TOL,
                               atol=DISTILL_TOL)
    assert state.step == int(new_state.step) == 1
    for path, want in leaves(np_tree(new_state.params)):
        got = state.model.get_parameter(path.replace("/", ".")).detach()
        np.testing.assert_allclose(got.numpy(), want, rtol=DISTILL_TOL,
                                   atol=DISTILL_TOL, err_msg=path)
    for n, p in t_model.named_parameters():
        assert p.grad is None and torch.equal(p, before[n]), n
