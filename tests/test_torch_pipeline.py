"""The port's pipeline (``parallel/pipeline.py``, the forward half of
``models/pipeline_lm.py`` and the ``"pipe"`` crossings of
``parallel/collectives.py``) against the JAX package's
``pipeline_apply`` and ``pipeline_lm_logits`` on its 8 CPU devices.

The port's meshes run in gangs of JAX-free processes over gloo on the
CPU (``parallel.launch.Gang``, rank bodies in ``tests/torch_pp_cases.py``),
one gang a mesh, started once for the module, each call bounded by the
gang's timeout; both packages get the same weights (the JAX init's, as
numpy) at float32, rtol = atol = 1e-5:

- the generic schedule: ``tanh(x @ w)`` stages, GPipe over 4 stages and
  circular (V 2) over 2 and 4, against the sequential chain and JAX's
  ``pipeline_apply``, with the stream's and every stage's gradient
  against autograd through the sequential chain;
- logits against JAX's ``pipeline_lm_logits``: GPipe on ``{"pipe": 2}``
  and ``{"pipe": 4}`` at 2 and 4 microbatches, circular V 2 at M = P and
  M > P, PP x TP on ``{"pipe": 2, "model": 2}``; the one-device
  pipeline against JAX's ``sequential_lm_logits``;
- the three crossings forward and backward on every rank; the JAX
  refusals under the same conditions; ``bubble_fraction``;
  ``init_pipeline_lm``'s tree and distributions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models.pipeline_lm import (
    init_pipeline_lm as jax_init_pipeline_lm,
    pipeline_lm_logits as jax_pipeline_lm_logits,
    sequential_lm_logits as jax_sequential_lm_logits,
    to_circular_layout as jax_to_circular_layout,
)
from kubegpu_tpu.parallel import device_mesh as jax_device_mesh
from kubegpu_tpu.parallel.pipeline import (
    bubble_fraction as jax_bubble_fraction,
    pipeline_apply as jax_pipeline_apply,
)
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.models.pipeline_lm import (
    PipelineLM,
    init_pipeline_lm,
    pipeline_lm_logits,
    pipeline_rules,
    place_pipeline_lm,
    to_circular_layout,
)
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
from kubegpu_tpu_torch.parallel.pipeline import bubble_fraction, pipeline_apply
import torch_pp_cases as cases

TOL = 1e-5
GANG_TIMEOUT_S = 300.0
MESHES = {"pipe2": {"pipe": 2}, "pipe4": {"pipe": 4},
          "pipe2_model2": {"pipe": 2, "model": 2}}
VOCAB, HIDDEN, HEADS, LAYERS, SEQ, BATCH = 64, 32, 4, 2, 16, 8


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


def jax_params(stages):
    return jax_init_pipeline_lm(
        jax.random.PRNGKey(0), vocab_size=VOCAB, num_stages=stages,
        layers_per_stage=LAYERS, hidden=HIDDEN, max_seq=SEQ + 1)


def tokens_np(seed=1):
    return np.random.RandomState(seed).randint(
        0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)


def cfg(stages, micro, rounds=1, model_axis=None):
    return dict(vocab_size=VOCAB, num_stages=stages,
                layers_per_stage=LAYERS, hidden=HIDDEN, num_heads=HEADS,
                num_microbatches=micro, max_seq=SEQ + 1, num_rounds=rounds,
                model_axis=model_axis)


# -- the generic schedule -----------------------------------------------------

CHAINS = [("pipe4", 1, 3), ("pipe2", 2, 2), ("pipe4", 2, 4)]


@pytest.mark.parametrize("mesh_name,rounds,micro", CHAINS,
                         ids=["gpipe-p4-m3", "circular-p2-v2-m2",
                              "circular-p4-v2-m4"])
def test_stage_chain_matches_the_sequential_chain_and_jax(
        gangs, mesh_name, rounds, micro):
    """``y = f_{S-1}(... f_0(x))`` for ``f_s = tanh(x @ w_s)``, global
    stage ``s = v*P + p`` at ``w[v, p]`` (circular); the stream's and
    every stage's gradient of ``sum(y^2)`` against autograd through the
    chain."""
    p = MESHES[mesh_name]["pipe"]
    rs = np.random.RandomState(0)
    lead = (rounds, p) if rounds > 1 else (p,)
    w = (rs.standard_normal(lead + (8, 8)) * 0.3).astype(np.float32)
    stream = rs.standard_normal((micro, 2, 8)).astype(np.float32)
    got = gangs[mesh_name].run(cases.stage_chain, dict(w=w, stream=stream,
                                                       rounds=rounds))
    wt = torch.from_numpy(w.reshape((-1, 8, 8))).requires_grad_()
    x = torch.from_numpy(stream).requires_grad_()
    y = x
    for s in range(wt.shape[0]):
        y = torch.tanh(y @ wt[s])
    (y * y).sum().backward()
    np.testing.assert_allclose(got["out"], y.detach().numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["g_stream"], x.grad.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["g_w"].reshape(wt.shape),
                               wt.grad.numpy(), rtol=TOL, atol=TOL)
    run = jax_pipeline_apply(lambda q, a: jnp.tanh(a @ q["w"]),
                             jax_mesh({"pipe": p}), num_rounds=rounds)
    want = jax.jit(run)({"w": jnp.asarray(w)}, jnp.asarray(stream))
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=TOL,
                               atol=TOL)


# -- logits --------------------------------------------------------------------

LOGIT_CASES = [
    # (mesh, microbatches, rounds, model_axis)
    ("pipe2", 2, 1, None), ("pipe2", 4, 1, None),
    ("pipe4", 2, 1, None), ("pipe4", 4, 1, None),
    ("pipe2", 2, 2, None), ("pipe2", 4, 2, None),
    ("pipe2_model2", 4, 1, "model"),
]
LOGIT_IDS = ["gpipe-p2-m2", "gpipe-p2-m4", "gpipe-p4-m2", "gpipe-p4-m4",
             "circular-p2-v2-m2", "circular-p2-v2-m4", "pp2-tp2-m4"]


@pytest.mark.parametrize("mesh_name,micro,rounds,model_axis", LOGIT_CASES,
                         ids=LOGIT_IDS)
def test_logits_match_jax_pipeline_lm_logits(gangs, mesh_name, micro,
                                             rounds, model_axis):
    axes = MESHES[mesh_name]
    p = axes["pipe"]
    params = jax_params(p * rounds)
    if rounds > 1:
        params = jax_to_circular_layout(params, p)
    tokens = tokens_np()
    want = jax.jit(lambda q, t: jax_pipeline_lm_logits(
        q, t, jax_mesh(axes), num_heads=HEADS, num_microbatches=micro,
        num_rounds=rounds, model_axis=model_axis))(params, tokens)
    got = gangs[mesh_name].run(cases.pp_logits, dict(
        params=np_tree(params), tokens=tokens,
        cfg=cfg(p * rounds, micro, rounds, model_axis)))
    np.testing.assert_allclose(got["logits"], np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_one_device_pipeline_matches_jax_sequential_logits():
    """One device (no mesh) runs the stack as V = S rounds over one
    stage: JAX's ``sequential_lm_logits`` on the same tree."""
    params = jax_params(4)
    tokens = tokens_np(2)
    want = jax_sequential_lm_logits(params, tokens, num_heads=HEADS)
    got = cases.pp_logits(None, dict(
        params=np_tree(jax_to_circular_layout(params, 1)), tokens=tokens,
        cfg=cfg(4, 2, rounds=4)))
    np.testing.assert_allclose(got["logits"], np.asarray(want), rtol=TOL,
                               atol=TOL)
    from kubegpu_tpu_torch.models.pipeline_lm import sequential_lm_logits

    seq = sequential_lm_logits(params_from_numpy(np_tree(params)),
                               torch.from_numpy(tokens), num_heads=HEADS)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# -- the crossings ---------------------------------------------------------------


def test_pipe_crossings_forward_and_backward(gangs):
    """On ``{"pipe": 4}``, rank r's input ``base + 100 r`` and upstream
    gradient ``r + 1``: the hop moves a tensor one stage on (GPipe: stage
    0 gets zeros; circular: stage 3's), its transpose one stage back
    (GPipe: stage 3 gets zeros); the entry is the identity forward and
    sums the gradient; the broadcast sums forward and passes the
    gradient."""
    every = gangs["pipe4"].run(cases.pipe_crossings)
    base = np.arange(6, dtype=np.float64).reshape(2, 3)
    ones = np.ones_like(base)
    for r, out in enumerate(every):
        assert out["coord"] == r

        def x(rank):
            return base + 100.0 * rank

        np.testing.assert_array_equal(out["hop"], x(r - 1) if r else 0 * base)
        np.testing.assert_array_equal(out["hop_wrap"], x((r - 1) % 4))
        np.testing.assert_array_equal(out["hop_back"],
                                      x(r + 1) if r < 3 else 0 * base)
        y, g = out["enter"]
        np.testing.assert_array_equal(y, x(r))
        np.testing.assert_array_equal(g, ones * (1 + 2 + 3 + 4))
        y, g = out["broadcast"]
        np.testing.assert_array_equal(y, sum(x(q) for q in range(4)))
        np.testing.assert_array_equal(g, ones * (r + 1))


# -- refusals --------------------------------------------------------------------


def fake_mesh(axes, rank=0):
    return Mesh(size=math.prod(axes.values()), rank=rank,
                device=torch.device("cpu"), backend="gloo",
                axis_names=tuple(axes),
                axis_sizes=tuple(axes.values()) if len(axes) > 1 else ())


def port_tree(stages, rounds=1, devices=1):
    tree = init_pipeline_lm(torch.Generator().manual_seed(0),
                            vocab_size=VOCAB, num_stages=stages,
                            layers_per_stage=LAYERS, hidden=HIDDEN,
                            max_seq=SEQ + 1, device="cpu")
    return to_circular_layout(tree, devices) if rounds > 1 else tree


def test_refuses_a_stack_whose_stage_dim_is_not_the_pipe_size():
    """JAX refuses a ``[4]`` stack on a 2-device ``"pipe"`` axis (the
    shard_map would drop stages); the port's placement refuses it alike,
    and ``pipeline_apply`` refuses a whole stack passed as one rank's."""
    mesh = jax_mesh({"pipe": 2})
    with pytest.raises(ValueError, match="has leading dim 4 but mesh axis "
                       "'pipe' has 2 devices"):
        jax_pipeline_apply(lambda q, a: a @ q["w"], mesh)(
            {"w": jnp.zeros((4, 8, 8))}, jnp.zeros((2, 2, 8)))
    model = PipelineLM(mesh=fake_mesh({"pipe": 2}), **cfg(2, 2))
    with pytest.raises(ValueError, match="has leading dim 4 but mesh axis "
                       "'pipe' has 2 devices"):
        place_pipeline_lm(model, port_tree(4))
    run = pipeline_apply(lambda q, a: a @ q["w"], fake_mesh({"pipe": 2}))
    with pytest.raises(ValueError, match=r"leads with \(2,\) on this rank"):
        run({"w": torch.zeros(2, 8, 8)}, torch.zeros(2, 2, 8))


def test_refuses_a_circular_stack_not_led_by_rounds_and_devices():
    mesh = jax_mesh({"pipe": 2})
    with pytest.raises(ValueError, match=r"must lead with \[num_rounds=2, "
                       r"devices=2\], got \(2, 4\)"):
        jax_pipeline_apply(lambda q, a: a @ q["w"], mesh, num_rounds=2)(
            {"w": jnp.zeros((2, 4, 8, 8))}, jnp.zeros((2, 2, 8)))
    model = PipelineLM(mesh=fake_mesh({"pipe": 2}), **cfg(4, 2, rounds=2))
    with pytest.raises(ValueError, match=r"must lead with \[num_rounds=2, "
                       r"devices=2\], got \(2, 4\)"):
        place_pipeline_lm(model, port_tree(8, rounds=2, devices=4))


def test_refuses_pp_x_tp_on_the_circular_schedule():
    """JAX refuses TP specs with ``num_rounds > 1`` (``pipeline_apply``'s
    ``params_specs``, ``pipeline_lm_logits``' and ``place_pipeline_lm``'s
    ``model_axis``); the port's ranks arrive with their leaves cut, so
    its refusal is ``model_axis`` with ``num_rounds > 1`` wherever one is
    taken."""
    mesh = jax_mesh({"pipe": 2, "model": 2})
    params = jax_to_circular_layout(jax_params(4), 2)
    with pytest.raises(ValueError, match="GPipe schedule only"):
        jax_pipeline_lm_logits(params, jnp.asarray(tokens_np()), mesh,
                               num_heads=HEADS, num_microbatches=2,
                               num_rounds=2, model_axis="model")
    with pytest.raises(ValueError, match="GPipe schedule only"):
        jax_pipeline_apply(lambda q, a: a, jax_mesh({"pipe": 2}),
                           num_rounds=2, params_specs={})
    port = port_tree(4, rounds=2, devices=2)
    with pytest.raises(ValueError, match="GPipe schedule only"):
        pipeline_lm_logits(port, torch.from_numpy(tokens_np()),
                           fake_mesh({"pipe": 2, "model": 2}),
                           num_heads=HEADS, num_microbatches=2, num_rounds=2,
                           model_axis="model")
    with pytest.raises(ValueError, match="GPipe schedule only"):
        PipelineLM(mesh=fake_mesh({"pipe": 2, "model": 2}),
                   **cfg(4, 2, rounds=2, model_axis="model"))
    with pytest.raises(ValueError, match="GPipe schedule only"):
        pipeline_rules(2, model_axis="model")


def test_refuses_fewer_microbatches_than_devices_on_the_circular_schedule():
    mesh = jax_mesh({"pipe": 4})
    with pytest.raises(ValueError, match="microbatches >= devices"):
        jax_pipeline_apply(lambda q, a: a @ q["w"], mesh, num_rounds=2)(
            {"w": jnp.zeros((2, 4, 8, 8))}, jnp.zeros((3, 2, 8)))
    run = pipeline_apply(lambda q, a: a @ q["w"], fake_mesh({"pipe": 4}),
                         num_rounds=2)
    with pytest.raises(ValueError, match=r"microbatches >= devices \(3 < 4\)"):
        run({"w": torch.zeros(2, 1, 8, 8)}, torch.zeros(3, 2, 8))


def test_refuses_a_batch_that_does_not_divide_into_microbatches():
    params = jax_params(2)
    with pytest.raises(ValueError, match="not divisible"):
        jax_pipeline_lm_logits(params, jnp.ones((3, 8), jnp.int32),
                               jax_mesh({"pipe": 2}), num_heads=HEADS,
                               num_microbatches=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by 2"):
        pipeline_lm_logits(port_tree(1), torch.ones(3, 8, dtype=torch.int32),
                           None, num_heads=HEADS, num_microbatches=2)


def test_refuses_stages_that_do_not_split_over_the_devices():
    with pytest.raises(ValueError, match="3 stages do not split over 2"):
        jax_to_circular_layout(jax_params(3), 2)
    with pytest.raises(ValueError, match="3 stages do not split over 2"):
        to_circular_layout(port_tree(3), 2)


# -- bubble fraction and init ------------------------------------------------------


@pytest.mark.parametrize("micro,stages,rounds", [
    (4, 4, 1), (4, 8, 1), (4, 4, 2), (8, 2, 3), (1, 1, 1)])
def test_bubble_fraction_is_jaxs(micro, stages, rounds):
    assert bubble_fraction(micro, stages, rounds) == pytest.approx(
        jax_bubble_fraction(micro, stages, rounds), rel=1e-15)
    assert bubble_fraction(4, 4, 2) < bubble_fraction(4, 8, 1)


def test_init_matches_jax_tree_and_distributions():
    """Same leaves, shapes and dtypes as the JAX init (float32; the head
    float32 under a bf16 init too); kernels a truncated normal of std
    ``1/sqrt(fan_in)`` cut at 2 std, embeddings std 0.02, LayerNorm
    scales 1 and biases 0, as JAX draws them (not its bits)."""
    kw = dict(vocab_size=256, num_stages=2, layers_per_stage=2, hidden=64,
              max_seq=128)
    want = np_tree(jax_init_pipeline_lm(jax.random.PRNGKey(0), **kw))
    got = init_pipeline_lm(torch.Generator().manual_seed(0), **kw,
                           device="cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    for name in ("embed", "pos", "ln_f_scale", "ln_f_bias", "lm_head"):
        assert tuple(got[name].shape) == want[name].shape, name
        assert got[name].dtype == torch.float32
    for name, w in want["blocks"].items():
        g = got["blocks"][name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    for name in ("ln1_scale", "ln2_scale"):
        assert (got["blocks"][name] == 1).all()
    for name in ("ln1_bias", "ln2_bias"):
        assert (got["blocks"][name] == 0).all()
    assert (got["ln_f_scale"] == 1).all() and (got["ln_f_bias"] == 0).all()
    for name, fan_in in (("wq", 64), ("w1", 64), ("w2", 256)):
        g, w = got["blocks"][name].numpy(), want["blocks"][name]
        assert abs(g.std() - w.std()) < 0.05 / math.sqrt(fan_in), name
        assert abs(g.std() * math.sqrt(fan_in) - 1) < 0.05, name
        bound = 2 / 0.87962566103423978 / math.sqrt(fan_in)
        assert np.abs(g).max() <= bound + 1e-6, name
        assert np.abs(w).max() <= bound + 1e-6, name
    head = got["lm_head"].numpy()
    assert abs(head.std() * 8 - 1) < 0.05
    for name in ("embed", "pos"):
        assert abs(got[name].numpy().std() - 0.02) < 1e-3, name
        assert abs(want[name].std() - 0.02) < 1e-3, name
    bf16 = init_pipeline_lm(torch.Generator().manual_seed(0), **kw,
                            dtype=torch.bfloat16, device="cpu")
    assert bf16["blocks"]["wq"].dtype == torch.bfloat16
    assert bf16["lm_head"].dtype == torch.float32
