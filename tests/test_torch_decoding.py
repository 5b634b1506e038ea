"""The port's dense decode model (kubegpu_tpu_torch/models/decoding.py)
and weight tree (models/params.py) against the JAX package at float32:
the same flax weights, carried over with ``params_from_numpy``, and the
same inputs give logits within rtol=atol=1e-5 and identical greedy
tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    DecodeLM as JaxDecodeLM,
    greedy_generate as jax_greedy_generate,
    init_caches as jax_init_caches,
)
from kubegpu_tpu_torch.models.decoding import (
    DecodeLM,
    generate,
    greedy_generate,
    init_caches,
)
from kubegpu_tpu_torch.models.params import (
    bf16_cast,
    bind_params,
    init_params,
    params_from_numpy,
)

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=32)
# float32 logits of two implementations that differ only in summation
# order (XLA vs PyTorch matmuls and reductions)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    model = TransformerLM(dtype=jnp.float32, **CFG)
    return model.init(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))[
        "params"
    ]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def test_params_from_numpy_round_trip(jax_params, torch_params):
    flat_j = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(torch_params))
    for path, leaf in flat_j:
        node = torch_params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_bf16_leaves_carry_over_exactly(jax_params):
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        jax_params)
    ported = params_from_numpy(tree)
    w = ported["layer0"]["attn"]["q_proj"]["kernel"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jax_params["layer0"]["attn"]["q_proj"]["kernel"]
                   .astype(jnp.bfloat16).astype(jnp.float32)),
    )
    cast = bf16_cast(params_from_numpy(jax.tree.map(np.asarray, jax_params)))
    assert all(t.dtype == torch.bfloat16 for t in _leaves(cast))


def test_init_params_has_the_flax_tree_shapes(jax_params):
    fresh = init_params(CFG, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        node = fresh
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    assert sum(1 for _ in _leaves(fresh)) == len(jax.tree.leaves(jax_params))
    # lecun-normal kernels: std 1/sqrt(fan_in), truncated at 2 std
    k = fresh["layer0"]["mlp_down"]["kernel"]
    assert abs(k.std().item() * np.sqrt(k.shape[0]) - 1.0) < 0.05
    assert k.abs().max().item() <= 2.0 / np.sqrt(k.shape[0]) / 0.8796 + 1e-6


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_prefill_and_step_logits_match_jax(jax_params, torch_params):
    """A batch of two prompts prefilled at per-sequence positions, then
    one decode step: logits of both calls and the written caches agree
    with the JAX DecodeLM."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, CFG["vocab_size"], size=(2, 7)).astype(np.int32)
    step = rng.randint(0, CFG["vocab_size"], size=(2, 1)).astype(np.int32)
    pos = np.array([0, 5], np.int32)
    jm = JaxDecodeLM(dtype=jnp.float32, **CFG)
    jc = jax_init_caches(2, CFG["num_layers"], CFG["num_heads"],
                         CFG["hidden"], CFG["max_seq"], jnp.float32)
    jl1, jc = jm.apply({"params": jax_params}, jnp.asarray(tokens), jc,
                       jnp.asarray(pos))
    jl2, jc = jm.apply({"params": jax_params}, jnp.asarray(step), jc,
                       jnp.asarray(pos + 7))

    tm = bind_params(DecodeLM(dtype=torch.float32, **CFG), torch_params)
    tc = init_caches(2, CFG["num_layers"], CFG["num_heads"], CFG["hidden"],
                     CFG["max_seq"], torch.float32)
    with torch.no_grad():
        tl1 = tm(torch.from_numpy(tokens), tc, torch.from_numpy(pos))
        tl2 = tm(torch.from_numpy(step), tc, torch.from_numpy(pos + 7))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("plen, steps", [(3, 9), (8, 12), (1, 20)])
def test_greedy_generate_tokens_identical(jax_params, torch_params, plen,
                                          steps):
    rng = np.random.RandomState(plen)
    prompt = rng.randint(0, CFG["vocab_size"], size=(2, plen)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(
        jax_params, jnp.asarray(prompt), steps, dtype=jnp.float32, **CFG
    ))
    got = greedy_generate(torch_params, torch.from_numpy(prompt), steps,
                          dtype=torch.float32, device="cpu", **CFG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_what_this_slice_does_not_serve(torch_params):
    """Sampling is served (tests/test_torch_sampling.py); what generate
    refuses, as the JAX function does, is a temperature without a key, a
    top_k past the vocabulary and a decode past the cache."""
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="rng key"):
        generate(torch_params, prompt, 2, temperature=0.7,
                 dtype=torch.float32, device="cpu", **CFG)
    with pytest.raises(ValueError, match="top_k"):
        generate(torch_params, prompt, 2, temperature=0.7, top_k=1000,
                 rng=torch.tensor([0, 1]), dtype=torch.float32, device="cpu",
                 **CFG)
    with pytest.raises(ValueError, match="max_seq"):
        greedy_generate(torch_params, prompt, 40, dtype=torch.float32,
                        device="cpu", **CFG)


@pytest.mark.parametrize("plen, steps", [(5, 10), (1, 12)])
def test_int8_greedy_generate_equals_jax(jax_params, torch_params, plen,
                                         steps):
    """``quant=True`` over a ``quantize_params_int8`` tree: the JAX
    function's weight-only int8 decode, token for token."""
    from kubegpu_tpu.models.decoding import (
        quantize_params_int8 as jax_quantize_params_int8,
    )
    from kubegpu_tpu_torch.models.decoding import quantize_params_int8

    prompt = (np.arange(2 * plen, dtype=np.int32)
              % CFG["vocab_size"]).reshape(2, plen)
    want = np.asarray(jax_greedy_generate(
        jax_quantize_params_int8(jax_params), jnp.asarray(prompt), steps,
        dtype=jnp.float32, quant=True, **CFG))
    got = greedy_generate(quantize_params_int8(torch_params),
                          torch.from_numpy(prompt), steps,
                          dtype=torch.float32, quant=True, device="cpu",
                          **CFG)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_decode_composes_with_int8_target(jax_params,
                                                      torch_params):
    """tests/test_generate.py:557: an int8 target verified against a
    full-width draft emits plain int8 greedy's tokens, and JAX's
    speculative tokens and verify count."""
    from kubegpu_tpu.models.decoding import (
        quantize_params_int8 as jax_quantize_params_int8,
    )
    from kubegpu_tpu.models.speculative import (
        speculative_generate as jax_speculative_generate,
    )
    from kubegpu_tpu_torch.models.decoding import quantize_params_int8
    from kubegpu_tpu_torch.models.speculative import speculative_generate

    draft = TransformerLM(dtype=jnp.float32, vocab_size=CFG["vocab_size"],
                          max_seq=CFG["max_seq"], num_layers=1, num_heads=2,
                          hidden=16)
    jd = draft.init(jax.random.PRNGKey(7),
                    jnp.ones((2, 8), jnp.int32))["params"]
    td = params_from_numpy(jax.tree.map(np.asarray, jd))
    prompt = (np.arange(2 * 5, dtype=np.int32)
              % CFG["vocab_size"]).reshape(2, 5)
    dims = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
    qj = jax_quantize_params_int8(jax_params)
    qt = quantize_params_int8(torch_params)
    want, want_calls = jax_speculative_generate(
        qj, jd, jnp.asarray(prompt), 10, k=3, dtype=jnp.float32, quant=True,
        **CFG, **dims)
    got, calls = speculative_generate(
        qt, td, torch.from_numpy(prompt), 10, k=3, dtype=torch.float32,
        quant=True, device="cpu", **CFG, **dims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == int(want_calls)
    plain = greedy_generate(qt, torch.from_numpy(prompt), 10,
                            dtype=torch.float32, quant=True, device="cpu",
                            **CFG)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
