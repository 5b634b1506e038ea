"""Data x tensor x context-parallel LM training in the port
(``TransformerLM(context_parallel=True, mesh=...)`` over a ``("data",
"model", "seq")`` mesh, ``train.place_lm``, ``lm_loss`` and
``sync_grads``) against the JAX package's ``make_lm_train_step`` under
``place_lm`` on the same 3-D mesh (``tests/test_models.py:325-378``).

The port's ranks run in one gang of eight JAX-free processes over gloo
on the CPU (``parallel.launch.Gang``, rank bodies in
``tests/torch_3d_cases.py``), started once for the module; the
fallback meshes are laid out on the same world (``mesh.remesh``).
JAX's side runs here on the 8 CPU devices of ``tests/conftest.py``, from
the same weights at float32 (the port's initializer, as numpy), at the
JAX test's widths (vocab 64, 2 layers, 4 heads, hidden 32, a batch of
2).

- ``{"data": 2, "model": 2, "seq": 2}``: one step's loss within 1e-5
  and every gradient leaf within rtol 1e-4, atol 1e-6 of JAX's, for ring
  through its flash body (16 rows a rank) and its einsum body (136, which
  ``ring_block_sizes`` does not tile), Ulysses and einsum attention; the
  heads stay sharded over ``"model"``.
- The two head-replication fallbacks of the JAX test: ring with 2 heads
  over ``{"data": 1, "model": 4, "seq": 2}`` (half a head a rank) and
  Ulysses with 4 heads over ``{"data": 1, "model": 2, "seq": 4}`` (2
  local heads do not divide over 4): the heads are replicated, the same
  gates hold.
- Three steps from a carried state with a non-zero momentum trace
  (einsum attention): losses, weights and momentum within 1e-5 of
  JAX's.
- The mesh's layout (its lines and the ``"data"`` x ``"seq"`` planes)
  and the new collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import TransformerLM as JaxTransformerLM
from kubegpu_tpu.models.train import (
    TrainState as JaxTrainState,
    lm_loss as jax_lm_loss,
    make_lm_train_step,
    place_lm as jax_place_lm,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu.parallel.sharding import current_mesh
from kubegpu_tpu_torch.models.params import init_params, tree_map
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_3d_cases as cases

AXES = {"data": 2, "model": 2, "seq": 2}
# max_seq holds the einsum body's 2 x 136 rows
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=273)
BATCH = 2
FLASH_SEQ, EINSUM_SEQ = 32, 272
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
STEP_TOL = 1e-5
GANG_TIMEOUT_S = 300.0


def tokens_np(seed, seq=FLASH_SEQ):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], size=(BATCH, seq + 1)).astype(np.int32)


def jax_state(cfg, attn_impl, params):
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    model = JaxTransformerLM(dtype=jnp.float32, attn_impl=attn_impl,
                             context_parallel=True, **cfg)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={}, opt_state=tx.init(params),
                         apply_fn=model.apply, tx=tx)


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


def init_tree(cfg, seed=0):
    """Fresh weights of the LM at ``cfg`` as numpy, fed to both packages
    (the port's initializer: no JAX compile for an init)."""
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t.numpy(),
                    init_params(cfg, gen, torch.float32, "cpu"))


@pytest.fixture(scope="module")
def params():
    return init_tree(CFG)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    # the ranks boot while the first case's JAX side compiles
    g = Gang(AXES, str(tmp_path_factory.mktemp("dp2tp2cp2")),
             backend="gloo", devices=["cpu"] * 8,
             timeout_s=GANG_TIMEOUT_S).start()
    yield g
    g.close()


def jax_grads(cfg, axes, attn_impl, params, tokens):
    mesh = jax_device_mesh(axes, devices=jax.devices()[:8])
    state, tok = jax_place_lm(jax_state(cfg, attn_impl, params),
                              jnp.asarray(tokens), mesh)
    with current_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_lm_loss(state, p, t)))(state.params, tok)
    return float(loss), np_tree(grads)


def check_against_jax(gang, cfg, axes, attn_impl, params, seq):
    tokens = tokens_np(2, seq)
    loss, grads = jax_grads(cfg, axes or AXES, attn_impl, params, tokens)
    got = gang.run(cases.grads_3d, dict(
        params=np_tree(params), cfg=cfg, axes=axes,
        model=dict(attn_impl=attn_impl), tokens=[tokens]))
    axes = axes or AXES
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_trees_close(got["grads"], grads, GRAD_RTOL, GRAD_ATOL)
    # every rank at its (data, model, seq) place, row-major as JAX lays
    # devices out; the CPU takes the twins: no kernel launched
    sizes = tuple(axes.values())
    assert got["coords"] == [tuple(map(int, np.unravel_index(r, sizes)))
                             for r in range(8)]
    assert not any(n for r in got["launches"] for n in r.values())
    return got


@pytest.mark.parametrize("attn_impl, seq", [
    pytest.param("ring", FLASH_SEQ, id="ring-flash-body"),
    pytest.param("ring", EINSUM_SEQ, id="ring-einsum-body"),
    pytest.param("ulysses", FLASH_SEQ, id="ulysses"),
    pytest.param("einsum", FLASH_SEQ, id="einsum"),
])
def test_dp2_tp2_cp2_loss_and_gradients_match_jax(gang, params, attn_impl,
                                                  seq):
    got = check_against_jax(gang, CFG, None, attn_impl, params, seq)
    assert not got["heads_replicated"]


@pytest.mark.parametrize("attn_impl, heads, axes", [
    # 2 heads over tp 4: a rank's 8 columns are half a head
    ("ring", 2, {"data": 1, "model": 4, "seq": 2}),
    # 4 / 2 local heads do not divide over seq 4
    ("ulysses", 4, {"data": 1, "model": 2, "seq": 4}),
])
def test_indivisible_heads_fall_back_to_replication_as_jax(gang, attn_impl,
                                                           heads, axes):
    cfg = dict(CFG, num_heads=heads, num_layers=1)
    got = check_against_jax(gang, cfg, axes, attn_impl, init_tree(cfg, 4),
                            FLASH_SEQ)
    assert got["heads_replicated"]


def test_three_carried_steps_match_make_lm_train_step(gang, params):
    """One JAX step makes the momentum trace non-zero; the state is then
    carried across, each rank keeping its shards, and both sides take
    the same three nesterov-SGD steps on the 3-D mesh.  Einsum attention
    (K/V gathered over "seq"): the gradient cases above hold ring and
    Ulysses, and the Pallas kernels' interpret mode would cost JAX's
    step a compile five times as long."""
    mesh = jax_device_mesh(AXES, devices=jax.devices()[:8])
    batches = [jnp.asarray(tokens_np(10 + i)) for i in range(4)]
    state, _ = jax_place_lm(jax_state(CFG, "einsum", params), batches[0],
                            mesh)
    step = make_lm_train_step(mesh, donate=False)
    state, _ = step(state, batches[0])
    got = gang.run(cases.steps_3d, dict(
        params=np_tree(state.params), trace=np_tree(state.opt_state[0].trace),
        step=int(state.step), cfg=CFG, model=dict(attn_impl="einsum"),
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


def test_the_3d_mesh_lays_ranks_out_as_jax(gang):
    """Rank r of ``{"data": 2, "model": 2, "seq": 2}`` sits at ``(r // 4,
    (r // 2) % 2, r % 2)``; its lines along each axis and its ``"data"``
    x ``"seq"`` plane (the ranks of its ``"model"`` coordinate) are the
    ranks that differ from it only there."""
    every = gang.run(cases.layout_3d, {})
    for r, got in enumerate(every):
        d, m, c = r // 4, (r // 2) % 2, r % 2
        assert got["coords"] == (d, m, c)
        assert got["groups"] == {
            "data": [m * 2 + c, 4 + m * 2 + c],
            "model": [d * 4 + c, d * 4 + 2 + c],
            "seq": [d * 4 + m * 2, d * 4 + m * 2 + 1],
            "data+seq": [m * 2, m * 2 + 1, 4 + m * 2, 5 + m * 2]}


def test_data_seq_mean_and_the_model_gather(gang):
    """``data_seq_mean`` averages over the four ranks of a ``"model"``
    coordinate (the gradient passes through); ``gather_axis`` over
    ``"model"`` along the last dim concatenates the two ``"model"``
    ranks' columns and reduce-scatters the gradient back."""
    every = gang.run(cases.collectives_3d, {})
    base = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for r, got in enumerate(every):
        m = (r // 2) % 2
        plane = [m * 2, m * 2 + 1, 4 + m * 2, 5 + m * 2]
        y, g = got["data_seq_mean"]
        np.testing.assert_array_equal(
            y, base + 1000.0 * np.mean(plane))
        np.testing.assert_array_equal(g, np.full_like(base, r + 1))
        pair = [r - 2 * m, r - 2 * m + 2]     # model coordinates 0, 1
        y, g = got["gather_model"]
        np.testing.assert_array_equal(
            y, np.concatenate([base + 1000.0 * p for p in pair], -1))
        # the gradient of this rank's columns: the sum over the pair of
        # their upstreams
        np.testing.assert_array_equal(g, np.full_like(base,
                                                      sum(pair) + 2))
