"""Tensor-parallel paged serving in the port (``PagedContinuousBatcher(
mesh=...)``, ``kubegpu_tpu_torch/parallel/``) against the JAX package's
``tests/test_tp_serving.py``.

The port's TP 2 batcher runs in a gang of two JAX-free processes over
gloo on the CPU (``parallel.launch.Gang``, rank bodies in
``tests/torch_tp_cases.py``), started once for the module;
its streams are compared here with the port's unsharded batcher and with
the JAX batcher on a 2-device "model" mesh (this process's 8 CPU
devices, from ``tests/conftest.py``), at float32, on the reference's
traffic: plain, synchronous, retirement sealing, speculative, int8 pool
(plain and speculative), weight-only int8 and seed-pinned sampled (plain
and speculative).  Every rank's pool, station and draft ring rest
exactly half of the unsharded batcher's bytes, the page accounting and
every rank's host state are checked against rank 0's after every step,
the ledger's TP economy and the ``serve_tp_*`` series equal the JAX
batcher's, and the construction refusals are the JAX batcher's.  Under
the batcher, the sharded attention wrappers equal the JAX package's
(K1, K1q, K2, K2q) and a TP 2 decode step, verify window and prefill
are within 1e-5 of the port's TP 1 and JAX's TP 2 logits.  TP 4 and
the page-size / sealing matrix are ``slow``, as in the reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    quantize_params_int8 as jax_quantize_params_int8,
)
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.models.decoding import quantize_params_int8
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
import torch_tp_cases as cases
from kubegpu_tpu_torch.utils.metrics import Metrics

# vocab and heads divisible by every tested width (the reference's)
CFG = dict(vocab_size=64, num_layers=2, num_heads=8, hidden=32, max_seq=32)
BASE_KW = dict(slots=4, prompt_pad=20, page_size=4, pool_pages=40)
TIMING = ("t", "host_ms", "device_ms")
GANG_TIMEOUT_S = 300.0
SAMPLED = dict(temperatures=[0.9, 0.0, 0.7, 1.0, 0.8, 0.6],
               seeds=[11, None, 13, 14, 15, 16])


@pytest.fixture(scope="module")
def params():
    model = TransformerLM(dtype=jnp.float32, **CFG)
    return model.init(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))[
        "params"]


@pytest.fixture(scope="module")
def np_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(2, str(tmp_path_factory.mktemp("tp2")), backend="gloo",
             devices=["cpu"] * 2, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


def traffic(seed=1, n_req=6):
    """The reference's traffic: mixed lengths and an in-burst
    duplicate (a prefix hit)."""
    rng = np.random.RandomState(seed)
    prompts = [np.array(rng.randint(0, CFG["vocab_size"], size=n), np.int32)
               for n in (1, 3, 5, 8, 13)[:n_req]]
    prompts.append(prompts[-1].copy())
    budgets = [5, 4, 6, 3, 5, 4][: len(prompts)]
    return prompts, budgets


def spec_kw(k=2, **kw):
    return dict(speculate_k=k, draft_num_layers=CFG["num_layers"],
                draft_num_heads=CFG["num_heads"], draft_hidden=CFG["hidden"],
                **kw)


# mode -> (constructor keywords, speculating, weight-only int8, run kw)
MODES = {
    "plain": (dict(), False, False, None),
    "synchronous": (dict(pipeline_decode=False), False, False, None),
    "decode-sealing": (dict(decode_page_cache="fp32"), False, False, None),
    "speculative": (spec_kw(), True, False, None),
    "int8-pool": (dict(kv_dtype="int8"), False, False, None),
    "int8-pool-speculative": (dict(kv_dtype="int8", **spec_kw()), True,
                              False, None),
    "int8-weights": (dict(), False, True, None),
    "sampled": (dict(top_k=8), False, False, SAMPLED),
    "sampled-speculative": (spec_kw(sampling=True), True, False, SAMPLED),
}


def jax_run(params, kw, spec, quant, run_kw, tp=2, metrics=None,
            prompts=None, budgets=None):
    mesh = device_mesh({"model": tp}, devices=jax.devices()[:tp])
    p = jax_quantize_params_int8(params) if quant else params
    extra = dict(draft_params=params) if spec else {}
    cb = JaxPagedContinuousBatcher(p, dtype=jnp.float32, mesh=mesh,
                                   quant=quant, metrics=metrics, **CFG,
                                   **BASE_KW, **kw, **extra)
    if prompts is None:
        prompts, budgets = traffic()
    return cb.run(prompts, budgets, **(run_kw or {})), cb


def port_tp1(np_params, kw, spec, quant, run_kw, metrics=None,
             prompts=None, budgets=None):
    params = params_from_numpy(np_params)
    extra = dict(draft_params=params) if spec else {}
    if quant:
        params = quantize_params_int8(params)
    cb = PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                quant=quant, metrics=metrics, **CFG,
                                **BASE_KW, **kw, **extra)
    if prompts is None:
        prompts, budgets = traffic()
    out = cb.run(prompts, budgets, **(run_kw or {}))
    cb.assert_page_accounting()
    return out, cb


def gang_spec(np_params, kw, spec, quant):
    return dict(params=np_params, cfg=CFG, kw=dict(BASE_KW, **kw),
                draft=np_params if spec else None, quant=quant)


def local_bytes(cb):
    return cases.rank_bytes(cb)


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_streams_equal_tp1_and_jax_tp2(gang, params, np_params, mode):
    """TP 2 emits exactly the unsharded port's tokens and the JAX TP 2
    batcher's, while every rank rests half the pool's, the station's and
    the draft ring's bytes and keeps rank 0's host state every step."""
    kw, spec, quant, run_kw = MODES[mode]
    prompts, budgets = traffic()
    ref, cb1 = port_tp1(np_params, kw, spec, quant, run_kw)
    want, _ = jax_run(params, kw, spec, quant, run_kw)
    got = gang.run(cases.serve, gang_spec(np_params, kw, spec, quant),
                   prompts, budgets, run_kw)
    assert got["streams"] == ref
    assert got["streams"] == want
    assert got["tp"] == 2
    assert got["stats"]["prefix_hit_tokens"] > 0    # the duplicate hit
    full = local_bytes(cb1)
    for rank, sizes in enumerate(got["rank_bytes"]):
        assert {k: 2 * v for k, v in sizes.items()} == full, rank
        assert sizes["pool"] == got["pool_bytes_per_device"]
    assert got["pool_kv_bytes"] == cb1.pool_kv_bytes
    assert got["pool_scale_bytes"] == cb1.pool_scale_bytes


def test_tp_ledger_and_metrics_report_per_device_economy(gang, params,
                                                         np_params):
    """The ledger's rows carry the TP economy (width, modeled collective
    wire bytes, resting pool bytes per device) row for row as the JAX
    TP 2 batcher's, and the ``serve_tp_*`` series mirror them; at TP 1
    the collective column is exactly zero."""
    prompts, budgets = traffic(seed=3, n_req=3)
    jm = JaxMetrics()
    _, jb = jax_run(params, {}, False, False, None, metrics=jm,
                    prompts=prompts, budgets=budgets)
    got = gang.run(cases.serve, gang_spec(np_params, {}, False, False),
                   prompts, budgets, None, True, False)
    jrows, trows = jb.ledger_rows(), got["ledger"]
    assert len(trows) == len(jrows)
    for tr_, jr in zip(trows, jrows):
        assert ({k: v for k, v in tr_.items() if k not in TIMING}
                == {k: v for k, v in jr.items() if k not in TIMING})
    assert all(r["tp"] == 2 for r in trows)
    assert any(r["collective_bytes"] > 0 for r in trows)
    total_pool = got["pool_kv_bytes"] + got["pool_scale_bytes"]
    assert all(r["pool_bytes_per_device"] == total_pool // 2 for r in trows)
    assert got["gauges"]["serve_tp_devices"] == 2.0
    assert got["gauges"]["serve_tp_pool_bytes_per_device"] == total_pool // 2
    assert (got["counters"]["serve_tp_collective_bytes_total"]
            == jm.get("serve_tp_collective_bytes_total") > 0)
    assert got["gauges"]["serve_pool_pages_free"] <= BASE_KW["pool_pages"] - 1

    m1 = Metrics()
    _, cb1 = port_tp1(np_params, {}, False, False, None, metrics=m1,
                      prompts=prompts, budgets=budgets)
    assert all(r["collective_bytes"] == 0 for r in cb1.ledger_rows())
    assert all(r["tp"] == 1 for r in cb1.ledger_rows())
    assert m1.gauge("serve_tp_devices") == 1.0
    assert m1.get("serve_tp_collective_bytes_total") == 0


def test_every_rank_keeps_rank0s_state_under_churn(gang, np_params):
    """Cancels, prefix hits, speculation and station churn (the JAX
    compile-stability schedule) at TP 2: the accounting balances and
    every rank's host state equals rank 0's after every step, and the
    finished streams are the unsharded batcher's."""
    kw = dict(station_slots=3, token_budget=11, prefill_chunk=8,
              **spec_kw())
    params = params_from_numpy(np_params)
    cb1 = PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                 draft_params=params, **CFG,
                                 **dict(BASE_KW, **kw))
    ref = cases.churn_schedule(cb1, 6, CFG["vocab_size"], 40)
    got = gang.run(cases.churn, gang_spec(np_params, kw, True, False), 6)
    assert got == ref
    assert any(ref.values())


def logits_inputs(quant: bool):
    """Pools with live rows in pages 1-6, two slots' tables, a 3-row
    window at rows 5 and 9, and a dense prompt."""
    rng = np.random.RandomState(5)
    hd = CFG["hidden"] // CFG["num_heads"]
    shape = (10, CFG["num_heads"], 4, hd)

    def side():
        x = rng.randn(*shape).astype(np.float32)
        if not quant:
            return x
        s = np.abs(x).max(axis=(2, 3)) / 127.0
        return (np.round(x / s[:, :, None, None]).astype(np.int8),
                s.astype(np.float32))

    return dict(pools=[(side(), side()) for _ in range(CFG["num_layers"])],
                table=np.array([[1, 2, 3], [4, 5, 6]], np.int32),
                pos=np.array([5, 9], np.int32),
                tokens=rng.randint(0, CFG["vocab_size"],
                                   size=(2, 3)).astype(np.int32),
                prompt=rng.randint(0, CFG["vocab_size"],
                                   size=(2, 7)).astype(np.int32))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32-pool",
                                                      "int8-pool"])
def test_tp2_logits_within_1e5_of_tp1_and_jax_tp2(gang, params, np_params,
                                                   quant):
    """The modules under the batcher: one paged decode step (K1/K1q's
    twin per head shard), a 3-row verify window (K2/K2q's) and a dense
    prefill at TP 2 are within 1e-5 of the unsharded port's and of the
    JAX package's (its paged model on a 2-device "model" mesh, its dense
    model unsharded): the row-parallel sums round differently, the
    gathers are exact."""
    from kubegpu_tpu.models.decoding import DecodeLM as JaxDecodeLM
    from kubegpu_tpu.models.paging import PagedDecodeLM as JaxPagedDecodeLM
    from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
    from kubegpu_tpu_torch.models.paging import PagedDecodeLM
    from kubegpu_tpu_torch.models.params import bind_params

    inp = logits_inputs(quant)
    got = gang.run(cases.forward_logits, np_params, CFG, inp)
    tparams = params_from_numpy(np_params)

    def t_pools():
        # copies: a forward writes its rows in place
        conv = (lambda a: tuple(torch.from_numpy(x.copy()) for x in a)
                if isinstance(a, tuple) else torch.from_numpy(a.copy()))
        return [tuple(conv(side) for side in layer) for layer in inp["pools"]]

    def j_pools():
        conv = (lambda a: tuple(jnp.asarray(x) for x in a)
                if isinstance(a, tuple) else jnp.asarray(a))
        return [tuple(conv(side) for side in layer) for layer in inp["pools"]]

    mesh = device_mesh({"model": 2}, devices=jax.devices()[:2])
    jkw = dict(dtype=jnp.float32, kv_quant=quant, **CFG)
    with torch.no_grad():
        for name, L in (("step", 1), ("verify", 3)):
            tok = inp["tokens"][:, :L]
            one = bind_params(PagedDecodeLM(dtype=torch.float32,
                                            all_logits=L > 1, **CFG),
                              tparams)(torch.from_numpy(tok), t_pools(),
                                       torch.from_numpy(inp["table"]),
                                       torch.from_numpy(inp["pos"]))
            jax_tp2, _ = JaxPagedDecodeLM(mesh=mesh, all_logits=L > 1,
                                          **jkw).apply(
                {"params": params}, jnp.asarray(tok), j_pools(),
                jnp.asarray(inp["table"]), jnp.asarray(inp["pos"]))
            np.testing.assert_allclose(got[name], one.numpy(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got[name], np.asarray(jax_tp2),
                                       rtol=1e-5, atol=1e-5)
        caches = init_caches(2, CFG["num_layers"], CFG["num_heads"],
                             CFG["hidden"], CFG["max_seq"], torch.float32)
        one = bind_params(DecodeLM(dtype=torch.float32, **CFG), tparams)(
            torch.from_numpy(inp["prompt"]), caches, 0)
    jmodel = JaxDecodeLM(dtype=jnp.float32, **CFG)
    jcaches = [(jnp.zeros(c.shape, jnp.float32),) * 2 for c, _ in caches]
    jout = jmodel.apply({"params": params}, jnp.asarray(inp["prompt"]),
                        jcaches, 0)[0]
    np.testing.assert_allclose(got["prefill"], one.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["prefill"], np.asarray(jout),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L, quant", [(1, False), (1, True), (4, False),
                                      (4, True)],
                         ids=["K1", "K1q", "K2", "K2q"])
def test_sharded_wrappers_equal_jax_sharded(L, quant):
    """``paged_{decode,chunk}_attention_sharded`` on each rank's half of
    8 heads (the plain twins on the CPU; no collective), put back in
    head order, equal the JAX package's sharded wrappers (the Pallas
    kernels per head shard under shard_map, interpret mode) within the
    reference's 2e-5."""
    from kubegpu_tpu.ops.paged_attention import (
        paged_chunk_attention_sharded as jax_chunk,
        paged_decode_attention_sharded as jax_decode,
    )
    from kubegpu_tpu_torch.ops.paged_attention import (
        paged_chunk_attention_sharded,
        paged_decode_attention_sharded,
    )

    rng = np.random.RandomState(11 + L + quant)
    b, h, hd, page, n_pages, pool = 3, 8, 16, 8, 4, 14
    q = rng.randn(*((b, h, hd) if L == 1 else (b, L, h, hd))).astype(
        np.float32)
    kv = [rng.randn(pool, h, page, hd).astype(np.float32) * 0.5
          for _ in range(2)]
    scales = {}
    if quant:
        sc = [np.abs(x).max(axis=(2, 3)) / 127.0 for x in kv]
        kv = [np.round(x / s[:, :, None, None]).astype(np.int8)
              for x, s in zip(kv, sc)]
        scales = dict(k_scale=sc[0].astype(np.float32),
                      v_scale=sc[1].astype(np.float32))
    table = np.stack([rng.permutation(np.arange(1, pool))[:n_pages]
                      for _ in range(b)]).astype(np.int32)
    lengths = np.array([1, 9, n_pages * page - L + 1], np.int32)
    jmesh = device_mesh({"model": 2}, devices=jax.devices()[:2])
    jfn = jax_decode if L == 1 else jax_chunk
    want = np.asarray(jfn(jnp.asarray(q), *map(jnp.asarray, kv),
                          jnp.asarray(table), jnp.asarray(lengths), jmesh,
                          **{k: jnp.asarray(v) for k, v in scales.items()}))
    tfn = (paged_decode_attention_sharded if L == 1
           else paged_chunk_attention_sharded)
    parts = []
    for rank in range(2):
        heads = slice(rank * h // 2, (rank + 1) * h // 2)
        parts.append(tfn(
            torch.from_numpy(q[..., heads, :].copy()),
            *(torch.from_numpy(x[:, heads].copy()) for x in kv),
            torch.from_numpy(table), torch.from_numpy(lengths),
            Mesh(size=2, rank=rank, device=torch.device("cpu"),
                 backend="gloo"), h,
            **{k: torch.from_numpy(v[:, heads].copy())
               for k, v in scales.items()}).numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=-2), want,
                               rtol=2e-5, atol=2e-5)


def _fake_mesh(size, axis="model"):
    """A mesh object for the constructor's refusals, which run before any
    collective."""
    return Mesh(size=size, rank=0, device=torch.device("cpu"),
                backend="gloo", axis_names=(axis,))


@pytest.mark.parametrize("case", ["no-model-axis", "num_heads", "vocab_size",
                                  "draft_num_heads"])
def test_tp_refusals_are_the_jax_batchers(params, np_params, case):
    """Malformed TP geometry fails at construction in both packages with
    the same ValueError, never mid-serve."""
    small = dict(slots=2, prompt_pad=8, page_size=4, pool_pages=8)
    cfg, extra = dict(CFG), {}
    if case == "no-model-axis":
        jmesh = device_mesh({"data": 2}, devices=jax.devices()[:2])
        tmesh, match = _fake_mesh(2, "data"), "model"
    elif case == "num_heads":
        cfg["num_heads"] = 4
        jmesh = device_mesh({"model": 8}, devices=jax.devices()[:8])
        tmesh, match = _fake_mesh(8), "num_heads"
    elif case == "vocab_size":
        cfg["vocab_size"] = 61
        jmesh = device_mesh({"model": 2}, devices=jax.devices()[:2])
        tmesh, match = _fake_mesh(2), "vocab_size"
    else:
        jmesh = device_mesh({"model": 2}, devices=jax.devices()[:2])
        tmesh, match = _fake_mesh(2), "draft_num_heads"
        extra = dict(speculate_k=2, draft_num_layers=2, draft_num_heads=3,
                     draft_hidden=30)
    with pytest.raises(ValueError, match=match):
        JaxPagedContinuousBatcher(
            params, dtype=jnp.float32, mesh=jmesh, **cfg, **small,
            **(dict(extra, draft_params=params) if extra else {}))
    tparams = params_from_numpy(np_params)
    with pytest.raises(ValueError, match=match):
        PagedContinuousBatcher(
            tparams, dtype=torch.float32, device="cpu", mesh=tmesh, **cfg,
            **small, **(dict(extra, draft_params=tparams) if extra else {}))


# ---------------------------------------------------------------------------
# slow tier: TP 4, the page-size x sealing matrix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    g = Gang(4, str(tmp_path_factory.mktemp("tp4")), backend="gloo",
             devices=["cpu"] * 4, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["plain", "synchronous", "speculative",
                                  "int8-pool"])
def test_tp4_streams_equal_tp1(gang4, np_params, mode):
    kw, spec, quant, run_kw = MODES[mode]
    prompts, budgets = traffic()
    ref, cb1 = port_tp1(np_params, kw, spec, quant, run_kw)
    got = gang4.run(cases.serve, gang_spec(np_params, kw, spec, quant),
                    prompts, budgets, run_kw)
    assert got["streams"] == ref
    full = local_bytes(cb1)
    for sizes in got["rank_bytes"]:
        assert {k: 4 * v for k, v in sizes.items()} == full


@pytest.mark.slow
@pytest.mark.parametrize("page_size", [4, 8])
def test_tp4_page_sizes_multiturn_sealing_identity(gang4, np_params,
                                                   page_size):
    """Turn 2 through a TP 4 batcher's sealed chain equals a cold
    unsharded batcher's, and its hits came from decode pages."""
    rng = np.random.RandomState(7)
    turn1 = np.array(rng.randint(0, CFG["vocab_size"], size=6), np.int32)
    kw = dict(BASE_KW, page_size=page_size, prompt_pad=24,
              decode_page_cache="fp32")
    params = params_from_numpy(np_params)
    ref1 = PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                  **CFG, **kw).run([turn1], [8])[0]
    got = gang4.run(cases.two_turns, dict(params=np_params, cfg=CFG, kw=kw),
                    turn1)
    assert got["turn1"] == ref1
    turn2 = np.concatenate([turn1, np.asarray(ref1, np.int32),
                            np.array([9, 1, 4], np.int32)])
    cold = PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                  **CFG, **dict(kw, prefix_cache=False))
    assert got["turn2"] == cold.run([turn2], [6])[0]
    assert got["decode_pages_sealed"] > 0
    assert got["prefix_hit_tokens_decode"] > 0
