"""The port's greedy speculative decoding against the JAX package at
float32: the paged model's verify window and the dense model's
``all_logits``, the dense ``speculative_generate`` oracle, and the
speculative ``PagedContinuousBatcher`` — whose streams must equal the
JAX speculative batcher's and the port's plain batcher's token for
token, for any draft, with the same ``spec_steps`` / ``spec_tokens`` /
``draft_wraps``.  Mirrors tests/test_spec_paged.py at the JAX tests'
widths (target: vocab 61, 2 layers, 4 heads, hidden 32, max_seq 32;
draft: 1 layer, 2 heads, hidden 16)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    DecodeLM as JaxDecodeLM,
    init_caches as jax_init_caches,
)
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
    PagedDecodeLM as JaxPagedDecodeLM,
)
from kubegpu_tpu.models.speculative import (
    speculative_generate as jax_speculative_generate,
)
from kubegpu_tpu_torch.models.decoding import (
    DecodeLM,
    greedy_generate,
    init_caches,
)
from kubegpu_tpu_torch.models.paging import (
    PagedContinuousBatcher,
    PagedDecodeLM,
)
from kubegpu_tpu_torch.models.params import bind_params, params_from_numpy
from kubegpu_tpu_torch.models.speculative import speculative_generate

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=32)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
PERFECT = dict(draft_num_layers=CFG["num_layers"],
               draft_num_heads=CFG["num_heads"], draft_hidden=CFG["hidden"])
LOGIT_TOL = 1e-5
# tests/test_spec_paged.py's batcher geometry
BATCHER_KW = dict(slots=4, prompt_pad=16, page_size=4, pool_pages=40)


@pytest.fixture(scope="module")
def jax_params():
    model = TransformerLM(dtype=jnp.float32, **CFG)
    return model.init(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))[
        "params"
    ]


@pytest.fixture(scope="module")
def jax_draft():
    # an independent random init: a HOPELESS draft (the all-reject path)
    model = TransformerLM(
        vocab_size=CFG["vocab_size"], max_seq=CFG["max_seq"],
        num_layers=DRAFT["draft_num_layers"],
        num_heads=DRAFT["draft_num_heads"], hidden=DRAFT["draft_hidden"],
        dtype=jnp.float32,
    )
    return model.init(jax.random.PRNGKey(7), jnp.ones((2, 8), jnp.int32))[
        "params"
    ]


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def weights(jax_params, jax_draft):
    """(jax target, jax draft, torch target, torch draft)."""
    return jax_params, jax_draft, to_torch(jax_params), to_torch(jax_draft)


def schedule():
    """tests/test_spec_paged.py's grid traffic: 10 sequences through 4
    slots, prompt lengths straddling page boundaries, a duplicate prompt
    (an in-burst prefix-cache hit), mixed budgets."""
    rng = np.random.RandomState(0)
    lengths = (1, 3, 4, 5, 7, 8, 9, 12, 13)
    prompts = [np.array(rng.randint(0, CFG["vocab_size"], size=n), np.int32)
               for n in lengths]
    prompts.append(prompts[6].copy())
    return prompts, [5, 4, 6, 3, 5, 4, 6, 5, 4, 5]


def port_oracle(tparams, prompt, n):
    out = greedy_generate(tparams, torch.from_numpy(prompt)[None], n,
                          dtype=torch.float32, device="cpu", **CFG)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def plain_streams(weights):
    """The port's non-speculative batcher on the grid traffic (itself
    held token-identical to the JAX batcher in test_torch_paging.py)."""
    prompts, budgets = schedule()
    cb = PagedContinuousBatcher(weights[2], dtype=torch.float32,
                                device="cpu", **CFG, **BATCHER_KW)
    out = cb.run(prompts, budgets)
    cb.assert_page_accounting()
    return out


def jax_spec(params, dparams, k, draft=DRAFT, **kw):
    return JaxPagedContinuousBatcher(
        params, dtype=jnp.float32, draft_params=dparams, speculate_k=k,
        **draft, **CFG, **{**BATCHER_KW, **kw})


def port_spec(params, dparams, k, draft=DRAFT, **kw):
    return PagedContinuousBatcher(
        params, dtype=torch.float32, draft_params=dparams, speculate_k=k,
        device="cpu", **draft, **CFG, **{**BATCHER_KW, **kw})


SPEC_STATS = ("steps", "spec_steps", "spec_tokens", "draft_wraps",
              "admits", "prefill_chunks", "prefix_hit_tokens")


def assert_same_run(jb, tb, got, want):
    assert got == want, {i: (got.get(i), want[i]) for i in want
                         if got.get(i) != want[i]}
    for key in SPEC_STATS:
        assert tb.stats[key] == jb.stats[key], key
    tb.assert_page_accounting()


# ---------------------------------------------------------------------------
# The models: the paged verify window and all_logits
# ---------------------------------------------------------------------------

def test_paged_decode_lm_verify_window_matches_jax(weights):
    """An L=3 window per slot through K2's twin: every row's logits within
    1e-5 of the JAX model's and the pools' written rows equal — slot 0's
    window crosses a page boundary, slot 2 is parked on the dump page."""
    jax_params, _, tparams, _ = weights
    rng = np.random.RandomState(3)
    hd = CFG["hidden"] // CFG["num_heads"]
    pools = [
        tuple((rng.randn(6, CFG["num_heads"], 4, hd) * 0.3).astype(np.float32)
              for _ in range(2))
        for _ in range(CFG["num_layers"])
    ]
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([6, 2, 0], np.int32)
    tokens = rng.randint(0, 61, size=(3, 3)).astype(np.int32)
    jl, jpools = JaxPagedDecodeLM(dtype=jnp.float32, all_logits=True,
                                  **CFG).apply(
        {"params": jax_params}, jnp.asarray(tokens),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools],
        jnp.asarray(table), jnp.asarray(pos),
    )
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]
    model = bind_params(PagedDecodeLM(dtype=torch.float32, all_logits=True,
                                      **CFG), tparams)
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), tpools, torch.from_numpy(table),
                   torch.from_numpy(pos))
    assert tl.shape == (3, 3, CFG["vocab_size"]) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the last row's logits are the default model's answer
    last = bind_params(PagedDecodeLM(dtype=torch.float32, **CFG), tparams)
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]
    with torch.no_grad():
        np.testing.assert_array_equal(
            last(torch.from_numpy(tokens), tpools, torch.from_numpy(table),
                 torch.from_numpy(pos)).numpy(), tl[:, -1].numpy())


def test_decode_lm_all_logits_matches_jax(weights):
    jax_params, _, tparams, _ = weights
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 61, size=(2, 5)).astype(np.int32)
    pos = np.array([0, 9], np.int32)
    jl, _ = JaxDecodeLM(dtype=jnp.float32, all_logits=True, **CFG).apply(
        {"params": jax_params}, jnp.asarray(tokens),
        jax_init_caches(2, CFG["num_layers"], CFG["num_heads"],
                        CFG["hidden"], CFG["max_seq"], jnp.float32),
        jnp.asarray(pos),
    )
    model = bind_params(DecodeLM(dtype=torch.float32, all_logits=True, **CFG),
                        tparams)
    caches = init_caches(2, CFG["num_layers"], CFG["num_heads"],
                         CFG["hidden"], CFG["max_seq"], torch.float32)
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), caches, torch.from_numpy(pos))
    assert tl.shape == (2, 5, CFG["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# The dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k, perfect", [(2, False), (4, True)],
                         ids=["k2-hopeless", "k4-perfect"])
def test_speculative_generate_matches_jax_and_greedy(weights, k, perfect):
    jax_params, jax_draft, tparams, tdraft = weights
    rng = np.random.RandomState(k)
    prompt = rng.randint(0, 61, size=(2, 5)).astype(np.int32)
    steps = 14
    jd, td, draft = ((jax_params, tparams, PERFECT) if perfect
                     else (jax_draft, tdraft, DRAFT))
    want, want_calls = jax_speculative_generate(
        jax_params, jd, jnp.asarray(prompt), steps, k=k, dtype=jnp.float32,
        **draft, **CFG)
    got, calls = speculative_generate(
        tparams, td, prompt, steps, k=k, dtype=torch.float32, device="cpu",
        **draft, **CFG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == int(want_calls)
    greedy = greedy_generate(tparams, prompt, steps, dtype=torch.float32,
                             device="cpu", **CFG)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    if perfect:
        assert calls == -(-(steps - 1) // (k + 1))


def test_speculative_generate_refuses_sampling_and_tight_caches(weights):
    """Sampling serves (tests/test_torch_sampling.py); temperatures that
    are not one per row are refused, as JAX refuses them."""
    _, _, tparams, tdraft = weights
    prompt = np.zeros((1, 4), np.int32)
    kw = dict(dtype=torch.float32, device="cpu", **DRAFT, **CFG)
    with pytest.raises(ValueError, match="temperatures must be shape"):
        speculative_generate(tparams, tdraft, prompt, 4,
                             temperatures=[0.7, 0.9], **kw)
    with pytest.raises(ValueError, match="max_seq"):
        speculative_generate(tparams, tdraft, prompt, 25, k=4, **kw)
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate(tparams, tdraft, prompt, 4, k=0, **kw)


# ---------------------------------------------------------------------------
# The batcher: spec-paged == JAX spec-paged == plain paged
# ---------------------------------------------------------------------------

GRID = [
    (1, dict()),
    (2, dict(station_slots=2)),
    (4, dict(station_slots=4)),
    (2, dict(token_budget=9)),
    (4, dict(station_slots=2, token_budget=12)),
]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("k, knobs", GRID,
                         ids=["k1", "k2-st2", "k4-st4", "k2-tb9",
                              "k4-st2-tb12"])
def test_spec_batcher_streams_identical_to_jax_and_plain(
        weights, plain_streams, k, knobs, pipeline):
    jax_params, jax_draft, tparams, tdraft = weights
    prompts, budgets = schedule()
    jb = jax_spec(jax_params, jax_draft, k, pipeline_decode=pipeline,
                  **knobs)
    tb = port_spec(tparams, tdraft, k, pipeline_decode=pipeline, **knobs)
    want = jb.run(prompts, budgets)
    got = tb.run(prompts, budgets)
    assert_same_run(jb, tb, got, want)
    assert got == plain_streams
    assert tb.stats["spec_steps"] > 0
    assert tb.stats["spec_tokens"] == sum(budgets)
    # the duplicate prompt still hits its twin's registered pages: the
    # verify windows write private pages only
    assert tb.stats["prefix_hit_tokens"] >= 8


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_perfect_draft_takes_fewer_verify_steps(weights, plain_streams,
                                                pipeline):
    """The target as its own draft: the all-accept path — same tokens,
    the same steps as the JAX batcher, strictly fewer verify programs
    than the hopeless draft, which still advances >= 1 token a verify."""
    jax_params, jax_draft, tparams, tdraft = weights
    prompts, budgets = schedule()
    jb = jax_spec(jax_params, jax_params, 4, draft=PERFECT,
                  pipeline_decode=pipeline)
    perfect = port_spec(tparams, tparams, 4, draft=PERFECT,
                        pipeline_decode=pipeline)
    want = jb.run(prompts, budgets)
    got = perfect.run(prompts, budgets)
    assert_same_run(jb, perfect, got, want)
    assert got == plain_streams
    hopeless = port_spec(tparams, tdraft, 4, pipeline_decode=pipeline)
    assert hopeless.run(prompts, budgets) == plain_streams
    hopeless.assert_page_accounting()
    assert perfect.stats["spec_steps"] < hopeless.stats["spec_steps"]
    assert hopeless.stats["spec_tokens"] >= hopeless.stats["spec_steps"]


def test_three_passes_on_one_warm_batcher_are_identical(weights,
                                                        plain_streams):
    """Later passes hit prefix pages that earlier passes sealed; a retired
    lane's overhang window must never write into them (the parked-lane
    rule), so every pass gives the same streams."""
    _, _, tparams, tdraft = weights
    prompts, budgets = schedule()
    tb = port_spec(tparams, tdraft, 3, station_slots=2, token_budget=10)
    for _ in range(3):
        assert tb.run(prompts, budgets) == plain_streams
        tb.assert_page_accounting()


@pytest.mark.parametrize("eos", [None, 7, 0], ids=["no-eos", "eos7", "eos0"])
def test_eos_early_exit_and_budget_cap(weights, eos):
    """A window may carry tokens past EOS or past the slot's budget: the
    surplus is dropped exactly as the plain batcher drops it, and the
    pages of retired sequences balance."""
    jax_params, jax_draft, tparams, tdraft = weights
    rng = np.random.RandomState(1)
    prompts = [np.array(rng.randint(0, 61, size=n), np.int32)
               for n in (3, 5, 7, 4)]
    budgets = [6, 9, 4, 8]
    plain = PagedContinuousBatcher(tparams, dtype=torch.float32,
                                   device="cpu", eos_id=eos, **CFG,
                                   **BATCHER_KW)
    expected = plain.run(prompts, budgets)
    plain.assert_page_accounting()
    jb = jax_spec(jax_params, jax_draft, 3, eos_id=eos)
    want = jb.run(prompts, budgets)
    for k in (1, 3):
        tb = port_spec(tparams, tdraft, k, eos_id=eos)
        got = tb.run(prompts, budgets)
        assert got == expected, (eos, k)
        tb.assert_page_accounting()
        for i, toks in got.items():
            assert len(toks) <= budgets[i]
            if eos is not None and eos in toks:
                assert toks.index(eos) == len(toks) - 1
        if k == 3:
            assert_same_run(jb, tb, got, want)


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_cancel_in_flight_keeps_survivors_oracle_exact(weights, pipeline):
    """Cancelling a mid-decode speculative sequence frees its pages (its
    junk window writes touch only pages it owned), and the survivors'
    tokens stay oracle-exact."""
    _, _, tparams, tdraft = weights
    rng = np.random.RandomState(2)
    prompts = [np.array(rng.randint(0, 61, size=n), np.int32)
               for n in (4, 6, 9, 5)]
    cb = port_spec(tparams, tdraft, 2, pipeline_decode=pipeline)
    for i, p in enumerate(prompts):
        cb.submit(i, p, 8)
    done = {}
    for _ in range(3):
        done.update(cb.serve_step())
    assert 1 in cb.live_tokens(), "seq 1 finished before the cancel"
    assert cb.cancel(1)
    while cb.has_work():
        done.update(cb.serve_step())
    assert 1 not in done
    for i in (0, 2, 3):
        assert done[i] == port_oracle(tparams, prompts[i], 8), i
    cb.assert_page_accounting()


# ---------------------------------------------------------------------------
# The draft ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k, window", [(2, 19), (4, 21)])
def test_draft_ring_wraps_and_leaves_tokens_unchanged(weights, k, window):
    """A ring barely above the validation floor wraps on long streams
    (the draft restarts its context at row 0); the streams stay
    oracle-exact and the wraps happen where the JAX batcher's do."""
    jax_params, jax_draft, tparams, tdraft = weights
    rng = np.random.RandomState(7)
    prompts = [np.array(rng.randint(0, 61, size=n), np.int32)
               for n in (3, 7, 12, 5)]
    budgets = [14, 10, 12, 16]
    expected = {i: port_oracle(tparams, p, n)
                for i, (p, n) in enumerate(zip(prompts, budgets))}
    jb = jax_spec(jax_params, jax_draft, k, draft_window=window)
    tb = port_spec(tparams, tdraft, k, draft_window=window)
    assert tb.draft_window == window
    assert tb.d_caches[0][0].shape[1] == window
    want = jb.run(prompts, budgets)
    got = tb.run(prompts, budgets)
    assert got == expected
    assert_same_run(jb, tb, got, want)
    assert tb.stats["draft_wraps"] > 0


def test_perfect_draft_through_a_wrapping_ring(weights):
    _, _, tparams, _ = weights
    rng = np.random.RandomState(7)
    prompts = [np.array(rng.randint(0, 61, size=n), np.int32)
               for n in (3, 7, 12, 5)]
    budgets = [14, 10, 12, 16]
    tb = port_spec(tparams, tparams, 2, draft=PERFECT, draft_window=19)
    got = tb.run(prompts, budgets)
    assert got == {i: port_oracle(tparams, p, n)
                   for i, (p, n) in enumerate(zip(prompts, budgets))}
    assert tb.stats["draft_wraps"] > 0
    tb.assert_page_accounting()


def test_draft_ring_default_is_the_jax_default(weights):
    _, _, tparams, tdraft = weights
    # min(max_seq, prompt_pad + 16 (k + 1)): max_seq wins here
    cb = port_spec(tparams, tdraft, 2)
    assert cb.draft_window == CFG["max_seq"]
    # the ring IS the draft cache's row count
    assert cb.d_caches[0][0].shape[1] == cb.draft_window
    tight = port_spec(tparams, tdraft, 2, draft_window=20)
    assert tight.d_caches[0][0].shape[1] == 20
    tight.assert_page_accounting()


# ---------------------------------------------------------------------------
# Guards: construction and submission contracts (the JAX messages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(speculate_k=0), "speculate_k"),
    (dict(speculate_k=2, draft_params=None), "draft model"),
    (dict(speculate_k=2, draft_window=18), "draft_window"),
    (dict(speculate_k=2, draft_window=64), "draft_window"),
    (dict(speculate_k=None, draft_window=20), "requires speculate_k"),
    (dict(speculate_k=32), "verify window exceeds max_seq"),
], ids=["k0", "no-draft", "ring-below-floor", "ring-past-max-seq",
        "ring-without-k", "window-past-max-seq"])
def test_speculation_knobs_are_validated(weights, kw, match):
    _, _, tparams, tdraft = weights
    kw = {"draft_params": tdraft, **DRAFT, **kw}
    with pytest.raises(ValueError, match=match):
        PagedContinuousBatcher(tparams, dtype=torch.float32, device="cpu",
                               **CFG, **BATCHER_KW, **kw)


def test_submit_guards_of_the_speculative_batcher(weights):
    _, _, tparams, tdraft = weights
    cb = port_spec(tparams, tdraft, 2)
    # greedy-only: lossless speculative SAMPLING is a different program
    with pytest.raises(ValueError, match="greedy-only"):
        cb.submit(0, np.array([1, 2], np.int32), 4, temperature=0.7)
    # k rows of cache headroom beyond the dense bound (max_seq 32)
    with pytest.raises(ValueError, match="headroom"):
        cb.submit(1, np.array([1, 2, 3], np.int32), 28)
    # the same request is fine without speculation
    PagedContinuousBatcher(tparams, dtype=torch.float32, device="cpu",
                           **CFG, **BATCHER_KW).submit(
        1, np.array([1, 2, 3], np.int32), 28)
    # the reservation carries k rows of write headroom
    assert cb._pages_for(3, 5) == -(-(3 + 5 + 2) // 4)
