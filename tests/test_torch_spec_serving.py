"""The port's speculative continuous batcher (kubegpu_tpu_torch/models/
spec_serving.py::SpeculativeContinuousBatcher) against the JAX
package's at float32 on the CPU: the same flax weights and numpy
requests give identical streams and ``stats`` for a hopeless draft (a
fresh 1-layer model) and a perfect one (the target), at k 1, 3 and 4;
the greedy streams also equal the port's ``ContinuousBatcher``.
Seed-pinned sampled streams (mixed with greedy rows) equal JAX's, the
greedy-only and headroom guards refuse as JAX's do, an int8 target
serves JAX's streams, and ``serve_spec_accept_rate{mode}`` counts match.
Mirrors tests/test_generate.py:444, :504, tests/test_sampled_spec.py:251
and :290."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    quantize_params_int8 as jax_quantize_params_int8,
)
from kubegpu_tpu.models.spec_serving import (
    SpeculativeContinuousBatcher as JaxSpeculativeContinuousBatcher,
)
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.models.decoding import quantize_params_int8
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.models.serving import ContinuousBatcher
from kubegpu_tpu_torch.models.spec_serving import SpeculativeContinuousBatcher
from kubegpu_tpu_torch.utils.metrics import Metrics

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=32)
HOPELESS = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
PERFECT = dict(draft_num_layers=2, draft_num_heads=4, draft_hidden=32)


@pytest.fixture(scope="module")
def weights():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    jd = TransformerLM(dtype=jnp.float32, vocab_size=CFG["vocab_size"],
                       max_seq=CFG["max_seq"], num_layers=1, num_heads=2,
                       hidden=16).init(jax.random.PRNGKey(7),
                                       jnp.ones((2, 8), jnp.int32))["params"]

    def port(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree))

    return {"hopeless": (jp, jd, port(jp), port(jd), HOPELESS),
            "perfect": (jp, jp, port(jp), port(jp), PERFECT)}


def build(weights, draft, side, quant=False, **kw):
    jp, jd, tp, td, dims = weights[draft]
    kw = dict(dict(CFG, slots=2, prompt_pad=8, **dims), **kw)
    if side == "jax":
        if quant:
            jp = jax_quantize_params_int8(jp)
        return JaxSpeculativeContinuousBatcher(
            jp, jd, dtype=jnp.float32, quant=quant, **kw)
    if quant:
        tp = quantize_params_int8(tp)
    return SpeculativeContinuousBatcher(tp, td, dtype=torch.float32,
                                        quant=quant, device="cpu", **kw)


def traffic(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=n).astype(np.int32)
            for n in lengths]


PROMPTS = traffic(11, (3, 5, 7, 4, 6))
BUDGETS = [6, 3, 5, 7, 4]


@pytest.fixture(scope="module")
def dense(weights):
    """The port's dense batcher's greedy streams (held against JAX's in
    tests/test_torch_dense_serving.py)."""
    _, _, tp, _, _ = weights["perfect"]
    return ContinuousBatcher(tp, dtype=torch.float32, device="cpu", slots=2,
                             prompt_pad=8, **CFG).run(PROMPTS, BUDGETS)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_greedy_streams_equal_jax_and_the_dense_batcher(weights, dense, k):
    steps = {}
    for draft in ("hopeless", "perfect"):
        tb = build(weights, draft, "torch", k=k)
        got = tb.run(PROMPTS, BUDGETS)
        assert got == dense, draft
        assert tb.stats["admits"] == 5
        assert tb.stats["tokens"] == sum(BUDGETS) - 5
        if draft == "hopeless" or k == 3:
            jb = build(weights, draft, "jax", k=k)
            assert jb.run(PROMPTS, BUDGETS) == got
            assert tb.stats == jb.stats
        steps[draft] = tb.stats["steps"]
    # the perfect draft accepts every proposal
    assert steps["perfect"] < steps["hopeless"]


TEMPS = [0.9, 0.0, 1.2, 0.8]
SEEDS = [41, None, 42, 43]


def test_seed_pinned_sampled_streams_equal_jax(weights):
    """tests/test_sampled_spec.py:251: mixed greedy and seed-pinned
    sampled rows through both packages; the pinned streams survive a
    change of slot count and a solo rerun; both modes of the accept-rate
    histogram count alike."""
    prompts = traffic(9, (3, 5, 7, 4))
    budgets = [8, 6, 7, 5]
    jm, tm = JaxMetrics(), Metrics()
    jb = build(weights, "hopeless", "jax", k=3, sampling=True, top_k=7,
               slots=4, metrics=jm)
    tb = build(weights, "hopeless", "torch", k=3, sampling=True, top_k=7,
               slots=4, metrics=tm)
    want = jb.run(prompts, budgets, temperatures=TEMPS, seeds=SEEDS)
    got = tb.run(prompts, budgets, temperatures=TEMPS, seeds=SEEDS)
    assert got == want and tb.stats == jb.stats
    for mode in ("greedy", "sampled"):
        assert (tm.histogram_count("serve_spec_accept_rate", mode=mode)
                == jm.histogram_count("serve_spec_accept_rate", mode=mode)
                > 0), mode
    again = build(weights, "hopeless", "torch", k=3, sampling=True,
                  top_k=7).run(prompts, budgets, temperatures=TEMPS,
                               seeds=SEEDS)
    assert again == got
    solo = build(weights, "hopeless", "torch", k=3, sampling=True,
                 top_k=7).run([prompts[2]], [budgets[2]],
                              temperatures=[TEMPS[2]], seeds=[42])
    assert solo[0] == got[2]


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_guards_equal_jax(weights):
    """tests/test_generate.py:504 and tests/test_sampled_spec.py:290."""
    cases = [
        ([np.array([1, 2], np.int32)], [2], [1.0]),
        ([np.arange(9, dtype=np.int32)], [0], None),
        # prompt 8 + max_new 22 fits the dense bound, not k=4's headroom
        ([np.arange(8, dtype=np.int32)], [22], None),
    ]
    sides = [build(weights, "perfect", side, k=4, slots=1)
             for side in ("jax", "torch")]
    for prompts, budgets, temps in cases:
        want = refusal(lambda: sides[0].run(prompts, budgets,
                                            temperatures=temps))
        assert want is not None
        assert refusal(lambda: sides[1].run(prompts, budgets,
                                            temperatures=temps)) == want
    for sb in sides:
        assert sb.run([np.array([1, 2, 3], np.int32)], [0]) == {0: []}
    for side in ("jax", "torch"):
        with pytest.raises(ValueError, match="k must be"):
            build(weights, "perfect", side, k=0)


def test_int8_target_equals_jax(weights, dense):
    """tests/test_generate.py:557 inside the batcher: an int8 target
    verified against a full-width draft emits JAX's int8 streams."""
    jb = build(weights, "hopeless", "jax", quant=True, k=3)
    tb = build(weights, "hopeless", "torch", quant=True, k=3)
    want = jb.run(PROMPTS, BUDGETS)
    assert tb.run(PROMPTS, BUDGETS) == want
    assert tb.stats == jb.stats
