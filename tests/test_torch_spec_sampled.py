"""Sampled paged serving of the port against the JAX package's, at
float32 on the CPU.

One schedule — six requests over four slots: seed-pinned sampled rows,
unpinned sampled rows (keys from the batcher's root key and the seq id),
a greedy row — runs through the JAX and the port
``PagedContinuousBatcher`` in every serving mode: plain (pipelined and
synchronous), ``top_k``, an int8 pool with quantized sealing, and
rejection-sampled speculation (``speculate_k=2, sampling=True``:
pipelined, synchronous, ``top_k``, int8 pool and ring).  Expected: equal
streams, equal ``stats``, equal ``serve_spec_accept_rate{mode}`` counts
and sums, equal F1 series (``serve_station_slots_busy`` step by step,
``serve_kv_quant_seal_requants_total``, the draft ring's gauges), and a
byte-identical replay on the same batcher.

Mirrors of tests/test_spec_paged_sampled.py (page 4 and page 8 at TP 1
against the JAX dense sampled-speculative batcher, the int8 ring's replay,
the ring-bytes gauge, sampled traffic keeping speculation and the
greedy-only guard), the seed pin (a pinned row's stream is the same alone
or in a batch), the sampling state held in fixed device tensors that no
step reads on the host, and the worker's ``--sample-*`` wave against the
JAX worker's recipe on the JAX batcher with the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.models.spec_serving import SpeculativeContinuousBatcher
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.models import worker
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import (
    init_params,
    params_from_numpy,
    tree_map,
)
from kubegpu_tpu_torch.utils.metrics import Metrics

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, max_seq=32)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
KW = dict(slots=4, prompt_pad=16, page_size=4, pool_pages=44)
BUDGETS = [8, 6, 7, 5, 6, 4]
TEMPS = [0.9, 0.0, 1.2, 0.8, 0.7, 1.0]
SEEDS = [41, None, 42, None, 43, None]   # pinned, greedy, root-key ...
SPEC = dict(speculate_k=2, sampling=True)

MODES = {
    "plain": {},
    "plain-synchronous": dict(pipeline_decode=False),
    "plain-top-k": dict(top_k=5),
    "int8-pool-sealing": dict(kv_dtype="int8",
                              decode_page_cache="quantized"),
    "speculative": SPEC,
    "speculative-synchronous": dict(SPEC, pipeline_decode=False),
    "speculative-top-k": dict(SPEC, top_k=3),
    "speculative-int8": dict(SPEC, kv_dtype="int8",
                             decode_page_cache="quantized"),
}


@pytest.fixture(scope="module")
def weights():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    jd = TransformerLM(
        vocab_size=CFG["vocab_size"], max_seq=CFG["max_seq"], num_layers=1,
        num_heads=2, hidden=16, dtype=jnp.float32,
    ).init(jax.random.PRNGKey(7), jnp.ones((2, 8), jnp.int32))["params"]

    def to_torch(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree))

    return jp, jd, to_torch(jp), to_torch(jd)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(9)
    return [np.array(rng.randint(0, CFG["vocab_size"], size=n), np.int32)
            for n in (3, 5, 7, 4, 6, 2)]


def build(weights, side, metrics=None, **kw):
    jp, jd, tp, td = weights
    spec = "speculate_k" in kw
    if side == "jax":
        return JaxPagedContinuousBatcher(
            jp, dtype=jnp.float32, metrics=metrics,
            **(dict(draft_params=jd, **DRAFT) if spec else {}),
            **CFG, **dict(KW, **kw))
    return PagedContinuousBatcher(
        tp, dtype=torch.float32, device="cpu", metrics=metrics,
        **(dict(draft_params=td, **DRAFT) if spec else {}),
        **CFG, **dict(KW, **kw))


def drive(cb, prompts, temps=TEMPS, seeds=SEEDS, budgets=BUDGETS):
    """Serve the schedule step by step; returns the streams and the
    ``serve_station_slots_busy`` gauge after every step."""
    for i, p in enumerate(prompts):
        cb.submit(i, p, budgets[i], temps[i], seed=seeds[i])
    done, busy = {}, []
    while cb.has_work():
        done.update(cb.serve_step())
        busy.append(cb.metrics.gauge("serve_station_slots_busy"))
    return done, busy


@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_streams_equal_the_jax_batchers(weights, prompts, mode):
    jm, tm = JaxMetrics(), Metrics()
    jb = build(weights, "jax", jm, **MODES[mode])
    tb = build(weights, "torch", tm, **MODES[mode])
    want, jbusy = drive(jb, prompts)
    got, tbusy = drive(tb, prompts)
    assert got == want, {i: (got[i], want[i]) for i in want
                         if got[i] != want[i]}
    assert [len(got[i]) for i in range(len(prompts))] == BUDGETS
    tb.assert_page_accounting()
    assert tb.stats == {k: v for k, v in jb.stats.items() if k in tb.stats}
    # F1: the station gauge, step by step
    assert tbusy == jbusy and max(tbusy) > 0
    for m_ in ("greedy", "sampled"):
        assert (tm.histogram_count("serve_spec_accept_rate", mode=m_)
                == jm.histogram_count("serve_spec_accept_rate", mode=m_))
        assert tm.histogram_sum("serve_spec_accept_rate", mode=m_) == (
            pytest.approx(jm.histogram_sum("serve_spec_accept_rate",
                                           mode=m_), abs=1e-12))
    dtype = "int8" if tb.kv_quant else "float32"
    assert (tm.get("serve_kv_quant_seal_requants_total")
            == jm.get("serve_kv_quant_seal_requants_total")
            == tb.stats["seal_requants"])
    for name, labels in (("serve_draft_cache_rows", {}),
                         ("serve_draft_ring_bytes", {"dtype": dtype}),
                         ("serve_draft_ring_bytes", {"dtype": "float32"})):
        assert tm.gauge(name, **labels) == jm.gauge(name, **labels), name
    if tb.speculate_k:
        assert tb.stats["spec_steps"] > 0
        assert tm.histogram_count("serve_spec_accept_rate",
                                  mode="sampled") > 0
        assert tm.gauge("serve_draft_cache_rows") > 0
    if tb.kv_quant:
        assert tb.stats["seal_requants"] > 0
    # replay: the same traffic on the same (warm) batcher
    again = tb.run(prompts, BUDGETS, temperatures=TEMPS, seeds=SEEDS)
    assert again == got


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_a_pinned_stream_is_the_same_alone_or_in_a_batch(weights, prompts,
                                                         spec):
    kw = SPEC if spec else {}
    batch = build(weights, "torch", **kw).run(
        prompts, BUDGETS, temperatures=TEMPS, seeds=SEEDS)
    alone = build(weights, "torch", **kw).run(
        [prompts[2]], [BUDGETS[2]], temperatures=[TEMPS[2]], seeds=[42])
    assert alone[0] == batch[2]
    other = build(weights, "torch", **kw).run(
        [prompts[2]], [BUDGETS[2]], temperatures=[TEMPS[2]], seeds=[777])
    assert other[0] != batch[2]


# -- mirrors of tests/test_spec_paged_sampled.py ----------------------------

MIRROR = dict(budgets=[8, 6, 7, 5], temps=[0.9, 0.0, 1.2, 0.8],
              seeds=[41, None, 42, 43])


def dense_ref(weights, prompts):
    """The JAX dense sampled-speculative stream (equal slots, k and draft
    geometry to the paged batchers below)."""
    jp, jd, _, _ = weights
    return SpeculativeContinuousBatcher(
        jp, jd, k=2, slots=4, prompt_pad=16, dtype=jnp.float32,
        sampling=True, **DRAFT, **CFG,
    ).run(prompts[:4], MIRROR["budgets"], temperatures=MIRROR["temps"],
          seeds=MIRROR["seeds"])


@pytest.mark.parametrize("page, pool", [(4, 44), (8, 24)])
def test_paged_sampled_spec_matches_dense(weights, prompts, page, pool):
    """With ``draft_window=max_seq`` the ring never wraps, so the paged
    proposal schedule is the dense batcher's row for row: the port's
    stream equals JAX's dense one, a fresh engine replays it, and both
    verify modes feed the labeled accept histogram."""
    ref = dense_ref(weights, prompts)
    m = Metrics()
    kw = dict(SPEC, page_size=page, pool_pages=pool,
              draft_window=CFG["max_seq"])
    cb = build(weights, "torch", m, **kw)
    got = cb.run(prompts[:4], MIRROR["budgets"],
                 temperatures=MIRROR["temps"], seeds=MIRROR["seeds"])
    assert got == ref, {i: (got[i], ref[i]) for i in ref if got[i] != ref[i]}
    cb.assert_page_accounting()
    again = build(weights, "torch", **kw).run(
        prompts[:4], MIRROR["budgets"], temperatures=MIRROR["temps"],
        seeds=MIRROR["seeds"])
    assert again == got
    assert m.histogram_count("serve_spec_accept_rate", mode="sampled") > 0
    assert m.histogram_count("serve_spec_accept_rate", mode="greedy") > 0


def test_int8_ring_replay_deterministic(weights, prompts):
    """Two fresh int8 engines replay each other, and the JAX int8 engine,
    token for token."""
    runs = [build(weights, side, **SPEC, kv_dtype="int8").run(
        prompts[:4], MIRROR["budgets"], temperatures=MIRROR["temps"],
        seeds=MIRROR["seeds"]) for side in ("torch", "torch", "jax")]
    assert runs[0] == runs[1] == runs[2]
    assert all(len(runs[0][i]) == MIRROR["budgets"][i] for i in runs[0])


def test_draft_ring_bytes_gauge(weights):
    """``serve_draft_ring_bytes`` by storage dtype: an int8 ring rests one
    byte an element plus float32 scales, a full-width ring one series at
    the compute dtype."""
    d_hd = DRAFT["draft_hidden"] // DRAFT["draft_num_heads"]
    elems = (2 * DRAFT["draft_num_layers"] * 4 * CFG["max_seq"]
             * DRAFT["draft_num_heads"] * d_hd)
    m8 = Metrics()
    build(weights, "torch", m8, **SPEC, kv_dtype="int8",
          draft_window=CFG["max_seq"])
    assert m8.gauge("serve_draft_ring_bytes", dtype="int8") == elems
    assert m8.gauge("serve_draft_ring_bytes", dtype="float32") == (
        2 * DRAFT["draft_num_layers"] * 4 * DRAFT["draft_num_heads"] * 4)
    assert m8.gauge("serve_draft_cache_rows") == 4 * CFG["max_seq"]
    mf = Metrics()
    build(weights, "torch", mf, **SPEC, draft_window=CFG["max_seq"])
    assert mf.gauge("serve_draft_ring_bytes", dtype="float32") == elems * 4


def test_sampled_traffic_keeps_speculation(weights, prompts):
    """A speculative batcher built with ``sampling=True`` runs sampled
    verify iterations for sampled traffic (the accept histogram's
    sampled series fills, each value in [0, 1]); one built without it
    refuses a sampled request at submit."""
    m = Metrics()
    cb = build(weights, "torch", m, **SPEC)
    out = cb.run(prompts[:2], [8, 6], temperatures=[0.9, 0.8],
                 seeds=[10, 11])
    assert [len(out[i]) for i in (0, 1)] == [8, 6]
    assert cb.stats["spec_steps"] > 0
    n = m.histogram_count("serve_spec_accept_rate", mode="sampled")
    assert n > 0
    assert 0.0 <= m.histogram_sum("serve_spec_accept_rate",
                                  mode="sampled") <= n
    greedy = build(weights, "torch", speculate_k=2)
    with pytest.raises(ValueError, match="greedy-only"):
        greedy.submit(0, prompts[0], 4, temperature=0.7)


# -- the sampling state stays on the device ---------------------------------

class NoHostRead(torch.Tensor):
    """A tensor whose values may not reach the host: converting it to a
    Python number, a list, numpy or a truth value raises; every other op
    runs and returns a plain tensor."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
             torch.Tensor.__bool__, torch.Tensor.__int__,
             torch.Tensor.__float__, torch.Tensor.__index__}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls.READS:
            raise AssertionError(f"sampling state read on the host: "
                                 f"{func.__name__}")
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["plain", "speculative"])
def test_the_sampling_state_is_never_read_on_the_host(weights, prompts,
                                                      mode):
    """Temperatures, base keys and key offsets are fixed device tensors:
    admission writes them in place and no step reads them back."""
    want = build(weights, "torch", **MODES[mode]).run(
        prompts, BUDGETS, temperatures=TEMPS, seeds=SEEDS)
    cb = build(weights, "torch", **MODES[mode])
    for name in ("_temps", "_base_keys", "_key_offsets"):
        setattr(cb, name, getattr(cb, name).as_subclass(NoHostRead))
    fixed = {n: getattr(cb, n) for n in ("_temps", "_base_keys",
                                         "_key_offsets")}
    with pytest.raises(AssertionError, match="host"):
        cb._temps.tolist()
    got = cb.run(prompts, BUDGETS, temperatures=TEMPS, seeds=SEEDS)
    assert got == want
    for name, t in fixed.items():
        assert getattr(cb, name) is t, name


# -- the worker ---------------------------------------------------------------

TINY = ["--model", "decode", "--serving", "paged", "--vocab", "64",
        "--hidden", "32", "--heads", "4", "--layers", "2", "--seq", "64",
        "--prompt-len", "16", "--page-size", "8", "--batch-per-chip", "2",
        "--steps", "8", "--device", "cpu", "--serve-fp32"]


@pytest.mark.parametrize("extra", [
    ["--sample-temperature", "0.8", "--sample-top-k", "5",
     "--sample-seed", "3"],
    ["--sample-temperature", "1.1", "--speculate", "--spec-k", "2"],
], ids=["plain-top-k", "speculative"])
def test_worker_sampled_wave_matches_the_jax_workers(extra):
    """The worker's ``--sample-*`` wave serves the streams of the JAX
    worker's sampled wave (request i pins seed ``--sample-seed + i``;
    ``kubegpu_tpu/models/worker.py:657-664``) run through the JAX batcher
    with the port worker's weights."""
    args = worker.build_parser().parse_args(TINY + extra)
    r = worker.run_decode(args)
    cfg = dict(vocab_size=64, num_layers=2, hidden=32, max_seq=65)
    params = init_params(cfg, torch.Generator().manual_seed(
        worker.WEIGHT_SEED), torch.float32, "cpu")

    def to_jax(tree):
        return tree_map(lambda t: jnp.asarray(t.numpy()), tree)

    spec_kw = {}
    if args.speculate:
        dparams, d_heads, d_hidden = worker.draft_for(args, 65, "cpu")
        spec_kw = dict(draft_params=to_jax(dparams), speculate_k=2,
                       draft_num_layers=1, draft_num_heads=d_heads,
                       draft_hidden=d_hidden)
    jb = JaxPagedContinuousBatcher(
        to_jax(params), num_heads=4, **cfg, slots=2, prompt_pad=16,
        page_size=8, pool_pages=2 * 4 + 1, dtype=jnp.float32,
        sampling=args.sample_temperature > 0, top_k=args.sample_top_k,
        **spec_kw)
    # the JAX worker's waves: prompts from RandomState(0), budgets cycling
    # 1/4 .. 1 x --steps, every request sampled and seed-pinned
    rng = np.random.RandomState(0)
    n = 4
    budgets = [max(8 * (1 + i % 4) // 4, 1) for i in range(n)]
    run_kw = dict(temperatures=[args.sample_temperature] * n,
                  seeds=[args.sample_seed + i for i in range(n)])
    for _ in range(2):   # the warm-up wave, then the timed one
        prompts = [rng.randint(0, 64, size=rng.randint(1, 17),
                               dtype=np.int32) for _ in range(n)]
        want = jb.run(prompts, budgets, **run_kw)
    assert r["outputs"] == want
    assert r["spec_steps"] > 0 if args.speculate else r["spec_steps"] == 0
