"""The port's int8 serving (kubegpu_tpu_torch) against the JAX package's
at float32 compute: the int8 page pool with its K1q/K2q plain twins, the
pool's storage codec and write rules (``quantize_pages``,
``_quant_write_row``, seal-time requantization, fresh-page scale
resets), weight-only int8 (``QuantDense``, ``quantize_params_int8``),
retirement sealing of decode pages, and the int8 batcher — plain and
speculative, with and without ``decode_page_cache="quantized"``.
Mirrors the in-scope cases of tests/test_quantized_pool.py and the fp32
two-turn sealing case of tests/test_multiturn_kv.py at small widths.

Tolerances: the elementwise quantizers are bit-exact against JAX on
identical float32 inputs; logits agree within 1e-5 and twins within the
reference kernel tolerance 2e-5; whole pools after a served schedule
agree within one int8 step (XLA's and torch's CPU GEMMs may put a K/V
value on the other side of a half-step), their scales within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.decoding import (
    DecodeLM as JaxDecodeLM,
    init_caches as jax_init_caches,
    quantize_params_int8 as jax_quantize_params_int8,
)
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
    PagedDecodeLM as JaxPagedDecodeLM,
    _quant_write_row as jax_quant_write_row,
)
from kubegpu_tpu.models.serving import (
    resolve_decode_page_cache as jax_resolve_decode_page_cache,
    resolve_kv_dtype as jax_resolve_kv_dtype,
)
from kubegpu_tpu.ops.paged_attention import (
    dequantize_pages as jax_dequantize_pages,
    paged_chunk_attention as jax_paged_chunk_attention,
    paged_decode_attention as jax_paged_decode_attention,
    quantize_pages as jax_quantize_pages,
)
from kubegpu_tpu_torch.models.decoding import (
    DecodeLM,
    init_caches,
    quantize_params_int8,
)
from kubegpu_tpu_torch.models.paging import (
    PagedContinuousBatcher,
    PagedDecodeLM,
    _quant_write_row,
    requantize_tight,
)
from kubegpu_tpu_torch.models.params import bind_params, params_from_numpy
from kubegpu_tpu_torch.models.serving import (
    DECODE_PAGE_CACHE_POLICIES,
    KV_DTYPES,
    resolve_decode_page_cache,
    resolve_kv_dtype,
)
from kubegpu_tpu_torch.ops.paged_attention import (
    check_chunk_args,
    check_kernel_args,
    dequantize_pages,
    paged_chunk_attention,
    paged_chunk_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    quantize_pages,
    reference_paged_attention,
    reference_paged_chunk_attention,
)

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=64)
F32_TOL = 2e-5
LOGIT_TOL = 1e-5
SCALE_RTOL = 1e-5
# tests/test_quantized_pool.py's batcher geometry (prompt pad 32 here, so
# a turn-2 prompt fits)
BATCHER_KW = dict(slots=3, prompt_pad=32, page_size=8, pool_pages=40)


@pytest.fixture(scope="module")
def jax_params():
    model = TransformerLM(dtype=jnp.float32, **CFG)
    return model.init(jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))[
        "params"
    ]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def spec_kw(params, k=2, **kw):
    return dict(draft_params=params, speculate_k=k,
                draft_num_layers=CFG["num_layers"],
                draft_num_heads=CFG["num_heads"], draft_hidden=CFG["hidden"],
                **kw)


def port(params, **kw):
    return PagedContinuousBatcher(params, dtype=torch.float32, device="cpu",
                                  **CFG, **{**BATCHER_KW, **kw})


def reference(params, **kw):
    return JaxPagedContinuousBatcher(params, dtype=jnp.float32, **CFG,
                                     **{**BATCHER_KW, **kw})


def traffic(rs, n=5, lo=4, hi=20):
    return [rs.randint(0, CFG["vocab_size"], size=rs.randint(lo, hi))
            .astype(np.int32) for _ in range(n)]


def assert_pools_close(jax_pools, port_pools):
    """Whole int8 pools within one int8 step and their scales within
    SCALE_RTOL, page 0 (the dump page idle slots write) excluded."""
    for (jk, jv), (tk, tv) in zip(jax_pools, port_pools):
        for (jd, js), (td, ts) in ((jk, tk), (jv, tv)):
            a = np.asarray(jd)[1:].astype(np.int32)
            b = td.numpy()[1:].astype(np.int32)
            assert np.abs(a - b).max() <= 1
            np.testing.assert_allclose(ts.numpy()[1:], np.asarray(js)[1:],
                                       rtol=SCALE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# The serving contract
# ---------------------------------------------------------------------------

def test_kv_dtype_contract_resolution():
    assert KV_DTYPES == ("bf16", "fp32", "int8")
    for name in (None, "bf16", "fp32", "int8", "fp16"):
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            try:
                want = jax_resolve_kv_dtype(name, jdt)
            except ValueError:
                with pytest.raises(ValueError):
                    resolve_kv_dtype(name, tdt)
                continue
            assert resolve_kv_dtype(name, tdt) == want, (name, tdt)
    assert resolve_kv_dtype("int8", torch.bfloat16)


def test_decode_page_cache_policy_resolution():
    assert DECODE_PAGE_CACHE_POLICIES == ("off", "fp32", "quantized", "all")
    for policy in DECODE_PAGE_CACHE_POLICIES:
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            for kv_quant in (False, True):
                assert resolve_decode_page_cache(policy, tdt, kv_quant) == (
                    jax_resolve_decode_page_cache(policy, jdt, kv_quant)
                ), (policy, tdt, kv_quant)
    with pytest.raises(ValueError):
        resolve_decode_page_cache("sometimes", torch.float32)


# ---------------------------------------------------------------------------
# The storage codec and the write rules, bit for bit
# ---------------------------------------------------------------------------

def test_quantize_and_dequantize_pages_bit_exact_against_jax():
    rs = np.random.RandomState(7)
    pages = (rs.randn(6, 3, 4, 8) * 3.0).astype(np.float32)
    pages[2, 1] = 0.0                      # an all-zero head keeps scale 0
    jd, js = jax_quantize_pages(jnp.asarray(pages))
    td, ts = quantize_pages(torch.from_numpy(pages))
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_pages(td, ts).numpy(),
        np.asarray(jax_dequantize_pages(jd, js)))
    np.testing.assert_array_equal(
        dequantize_pages(td, ts, torch.bfloat16).float().numpy(),
        np.asarray(jax_dequantize_pages(jd, js, jnp.bfloat16)
                   .astype(jnp.float32)))


def test_quantize_pages_roundtrip_properties():
    """Mirror of tests/test_quantized_pool.py's roundtrip case."""
    rs = np.random.RandomState(7)
    pages = torch.from_numpy(rs.randn(6, 3, 4, 8).astype(np.float32)) * 3.0
    data, scale = quantize_pages(pages)
    err = (dequantize_pages(data, scale) - pages).abs()
    assert (err <= scale[:, :, None, None] * 0.5 + 1e-7).all()
    mx = data.abs().amax(dim=(2, 3))
    assert ((mx == 127) | (scale == 0.0)).all()
    zd, zs = quantize_pages(torch.zeros((2, 3, 4, 8)))
    assert not zd.any() and not zs.any()


@pytest.mark.parametrize("case", ["grow", "keep", "zero-scale"])
def test_quant_write_row_bit_exact_against_jax(case):
    """The grow-and-rescale row commit: a row that grows its page's scale
    rescales the page, one inside the scale keeps it, and a zero scale (a
    fresh page) wipes the stale int8 the page held."""
    rs = np.random.RandomState({"grow": 1, "keep": 2, "zero-scale": 3}[case])
    P, h, page, hd, b = 6, 3, 4, 8, 3
    data, scale = quantize_pages(
        torch.from_numpy(rs.randn(P, h, page, hd).astype(np.float32)))
    if case == "zero-scale":
        scale[[1, 4]] = 0.0
    rows = rs.randn(b, h, hd).astype(np.float32)
    rows *= {"grow": 4.0, "keep": 0.25, "zero-scale": 1.0}[case]
    page_ids = np.array([1, 4, 2], np.int32)
    offs = np.array([0, 3, 2], np.int32)
    jd, js = jax_quant_write_row(jnp.asarray(data.numpy()),
                                 jnp.asarray(scale.numpy()),
                                 jnp.asarray(page_ids), jnp.asarray(offs),
                                 jnp.asarray(rows))
    before = scale.clone()
    _quant_write_row(data, scale, torch.from_numpy(page_ids).long(),
                     torch.from_numpy(offs).long(), torch.from_numpy(rows))
    np.testing.assert_array_equal(data.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    grew = (scale > before)[torch.from_numpy(page_ids).long()]
    if case == "keep":
        assert not grew.any()
    else:   # every written page grows (from 0 where it was fresh)
        assert grew[:2].all() and (case == "zero-scale" or grew.all())
    if case == "zero-scale":
        # only the written row survives on a page that started at scale 0
        blk = data[1].clone()
        blk[:, 0] = 0
        assert not blk.any()


def test_seal_requantization_bit_exact_against_jax(jax_params):
    """The seal-time requantization of the port against the JAX
    batcher's requant program, on pages whose scales were inflated by a
    row later overwritten with smaller values."""
    rs = np.random.RandomState(4)
    P, h, page, hd = 10, CFG["num_heads"], 8, CFG["hidden"] // CFG["num_heads"]
    data, scale = quantize_pages(
        torch.from_numpy(rs.randn(P, h, page, hd).astype(np.float32)))
    data = (data.int() // 3).to(torch.int8)    # max|int8| well below 127
    data[5] = 0                                 # an all-zero page
    scale = scale * 3.0
    phys = [2, 5, 7]
    jb = reference(jax_params, kv_dtype="int8", page_size=page,
                   pool_pages=P)
    # fresh arrays for every entry: the program donates its pools
    pools = [tuple((jnp.asarray(data.numpy()), jnp.asarray(scale.numpy()))
                   for _ in range(2)) for _ in range(CFG["num_layers"])]
    width = 4
    pv = np.zeros((width,), np.int32)
    pv[: len(phys)] = phys
    out = jb._get_requant_pages(width)(pools, jnp.asarray(pv),
                                       jnp.int32(len(phys)))
    jd, js = out[0][0]
    idx = torch.tensor(phys)
    nd, ns = requantize_tight(data[idx], scale[idx])
    # XLA compiles the program's divisions by 127 and by max|x| into
    # reciprocal multiplies, which round differently from a division:
    # one f32 ulp on a scale and one step on an int8 value, no more
    diff = np.abs(nd.numpy().astype(np.int32)
                  - np.asarray(jd)[phys].astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    np.testing.assert_array_max_ulp(ns.numpy(), np.asarray(js)[phys],
                                    maxulp=1)
    mx = nd.abs().amax(dim=(2, 3))
    assert ((mx == 127) | (ns == scale[idx])).all()


def test_fresh_page_scale_reset_matches_jax(jax_params, torch_params):
    rs = np.random.RandomState(6)
    jb = reference(jax_params, kv_dtype="int8")
    tb = port(torch_params, kv_dtype="int8")
    scales = [rs.rand(BATCHER_KW["pool_pages"], CFG["num_heads"])
              .astype(np.float32) for _ in range(2 * CFG["num_layers"])]
    jb.pools = [((kd, jnp.asarray(scales[2 * i])),
                 (vd, jnp.asarray(scales[2 * i + 1])))
                for i, ((kd, _), (vd, _)) in enumerate(jb.pools)]
    for i, ((_, ks), (_, vs)) in enumerate(tb.pools):
        ks.copy_(torch.from_numpy(scales[2 * i]))
        vs.copy_(torch.from_numpy(scales[2 * i + 1]))
    fresh = [9, 3, 17, 3]
    jb._zero_page_scales(fresh)
    tb._zero_page_scales(fresh)
    for (jk, jv), (tk, tv) in zip(jb.pools, tb.pools):
        for (_, js), (_, ts) in ((jk, tk), (jv, tv)):
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            assert not ts[[3, 9, 17]].any() and ts[1].all()


def test_quantize_params_int8_bit_exact_against_jax(jax_params):
    want = jax.tree.map(np.asarray, jax_quantize_params_int8(jax_params))
    got = quantize_params_int8(params_from_numpy(
        jax.tree.map(np.asarray, jax_params)))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        assert node.dtype == {np.dtype(np.int8): torch.int8,
                              np.dtype(np.float32): torch.float32}[leaf.dtype]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert set(got["lm_head"]) == {"kernel_int8", "qscale"}
    assert set(got["embed"]) == {"embedding"}


# ---------------------------------------------------------------------------
# K1q / K2q plain twins against the Pallas quant kernels (interpret mode)
# ---------------------------------------------------------------------------

def quant_case(seed, page, hd, P=12, h=4, b=3, npg=3, L=3):
    rs = np.random.RandomState(seed)
    kd, ks = quantize_pages(torch.from_numpy(
        rs.randn(P, h, page, hd).astype(np.float32)))
    vd, vs = quantize_pages(torch.from_numpy(
        rs.randn(P, h, page, hd).astype(np.float32)))
    table = np.stack([rs.choice(np.arange(1, P), size=npg, replace=False)
                      for _ in range(b)]).astype(np.int32)
    lengths = rs.randint(1, npg * page - L, size=b).astype(np.int32)
    lengths[0] = 0 if npg * page > 8 else lengths[0]
    q = rs.randn(b, L, h, hd).astype(np.float32)
    return q, (kd, vd, ks, vs), table, lengths


def jax_quant(fn, q, pools, table, lengths):
    kd, vd, ks, vs = (jnp.asarray(t.numpy()) for t in pools)
    return np.asarray(fn(jnp.asarray(q), kd, vd, jnp.asarray(table),
                         jnp.asarray(lengths), k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("page, hd", [(4, 8), (8, 16), (16, 128)])
def test_quant_twins_match_the_jax_quant_kernels(page, hd):
    q, pools, table, lengths = quant_case(3, page, hd)
    kd, vd, ks, vs = pools
    tbl, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    qt = torch.from_numpy(q)
    deq = (dequantize_pages(kd, ks), dequantize_pages(vd, vs))
    # K1q: the window's first row
    out = paged_decode_attention_plain(qt[:, 0], kd, vd, tbl, ln, ks, vs)
    want = jax_quant(jax_paged_decode_attention, q[:, 0], pools, table,
                     lengths)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        out.numpy(), reference_paged_attention(qt[:, 0], *deq, tbl,
                                               ln).numpy(),
        rtol=F32_TOL, atol=F32_TOL)
    # K2q, and its rows against K1q at lengths + j, bit for bit
    outc = paged_chunk_attention_plain(qt, kd, vd, tbl, ln, ks, vs)
    wantc = jax_quant(jax_paged_chunk_attention, q, pools, table, lengths)
    np.testing.assert_allclose(outc.numpy(), wantc, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(
        outc.numpy(), reference_paged_chunk_attention(qt, *deq, tbl,
                                                      ln).numpy(),
        rtol=F32_TOL, atol=F32_TOL)
    for j in range(q.shape[1]):
        assert torch.equal(outc[:, j], paged_decode_attention_plain(
            qt[:, j].contiguous(), kd, vd, tbl, ln + j, ks, vs))


def test_quant_wrappers_take_the_twins_on_the_cpu_without_a_launch():
    q, (kd, vd, ks, vs), table, lengths = quant_case(5, 8, 16)
    tbl, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    qt = torch.from_numpy(q)
    before = (paged_decode_attention.launches,
              paged_decode_attention.int8_launches,
              paged_chunk_attention.launches,
              paged_chunk_attention.int8_launches)
    a = paged_decode_attention(qt[:, 0], kd, vd, tbl, ln, k_scale=ks,
                               v_scale=vs)
    c = paged_chunk_attention(qt, kd, vd, tbl, ln, k_scale=ks, v_scale=vs)
    assert (paged_decode_attention.launches,
            paged_decode_attention.int8_launches,
            paged_chunk_attention.launches,
            paged_chunk_attention.int8_launches) == before
    assert torch.equal(a, paged_decode_attention_plain(qt[:, 0], kd, vd,
                                                       tbl, ln, ks, vs))
    assert torch.equal(c, paged_chunk_attention_plain(qt, kd, vd, tbl, ln,
                                                      ks, vs))


@pytest.mark.parametrize("bad, match", [
    (dict(pool_dtype=torch.float32), "must be int8"),
    (dict(scale_dtype=torch.float64), "float32"),
    (dict(scale_rows=5), "scales must be"),
    (dict(one_scale=True), "together"),
    (dict(transposed_scale=True), "contiguous"),
])
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(bad, match):
    h, P = 8, 6
    pool = torch.zeros((P, h, 16, 128), dtype=bad.get("pool_dtype",
                                                      torch.int8))
    scale = torch.zeros((bad.get("scale_rows", P), h),
                        dtype=bad.get("scale_dtype", torch.float32))
    if bad.get("transposed_scale"):
        scale = torch.zeros((h, P)).t()
    v_scale = None if bad.get("one_scale") else scale
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    for check, q in ((check_kernel_args, torch.zeros((2, h, 128))),
                     (check_chunk_args, torch.zeros((2, 3, h, 128)))):
        with pytest.raises(ValueError, match=match):
            check(q, pool, pool, table, lengths, scale, v_scale)


def test_quant_wrappers_take_the_serving_layout():
    pool = torch.zeros((3, 8, 16, 128), dtype=torch.int8)
    scale = torch.zeros((3, 8))
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones((2,), dtype=torch.int32)
    for q in (torch.zeros((2, 8, 128), dtype=torch.bfloat16),
              torch.zeros((2, 8, 128))):
        check_kernel_args(q, pool, pool, table, lengths, scale, scale)
        check_chunk_args(q[:, None].expand(2, 5, 8, 128).contiguous(), pool,
                         pool, table, lengths, scale, scale)


# ---------------------------------------------------------------------------
# The models: QuantDense logits, and the int8 paged step and verify window
# ---------------------------------------------------------------------------

def test_quant_decode_lm_logits_match_jax(jax_params):
    qparams = jax_quantize_params_int8(jax_params)
    tparams = quantize_params_int8(params_from_numpy(
        jax.tree.map(np.asarray, jax_params)))
    rs = np.random.RandomState(2)
    prompt = rs.randint(0, 61, size=(2, 9)).astype(np.int32)
    jl, _ = JaxDecodeLM(dtype=jnp.float32, quant=True, all_logits=True,
                        **CFG).apply(
        {"params": qparams}, jnp.asarray(prompt),
        jax_init_caches(2, CFG["num_layers"], CFG["num_heads"], CFG["hidden"],
                        CFG["max_seq"], jnp.float32), jnp.int32(0))
    model = bind_params(DecodeLM(dtype=torch.float32, quant=True,
                                 all_logits=True, **CFG), tparams)
    with torch.no_grad():
        tl = model(torch.from_numpy(prompt),
                   init_caches(2, CFG["num_layers"], CFG["num_heads"],
                               CFG["hidden"], CFG["max_seq"], torch.float32),
                   0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("L, quant", [(1, False), (3, False), (3, True)],
                         ids=["step", "verify-window", "verify-int8-weights"])
def test_paged_lm_int8_pool_logits_and_writes_match_jax(jax_params, L, quant):
    """One decode step (K1q's twin) or a verify window (K2q's) from the
    same int8 pools and scales: logits within 1e-5, and the rows the
    window commits through grow-and-rescale within one int8 step."""
    rs = np.random.RandomState(10 + L)
    hd = CFG["hidden"] // CFG["num_heads"]
    pools_np = []
    for _ in range(CFG["num_layers"]):
        side = []
        for _ in range(2):
            d, s = quantize_pages(torch.from_numpy(
                (rs.randn(8, CFG["num_heads"], 4, hd) * 0.3)
                .astype(np.float32)))
            side.append((d.numpy(), s.numpy()))
        pools_np.append(side)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    tokens = rs.randint(0, 61, size=(3, L)).astype(np.int32)
    jparams = jax_quantize_params_int8(jax_params) if quant else jax_params
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    jl, jpools = JaxPagedDecodeLM(dtype=jnp.float32, kv_quant=True,
                                  quant=quant, all_logits=L > 1, **CFG).apply(
        {"params": jparams}, jnp.asarray(tokens),
        [tuple((jnp.asarray(d), jnp.asarray(s)) for d, s in side)
         for side in pools_np],
        jnp.asarray(table), jnp.asarray(pos))
    tpools = [tuple((torch.from_numpy(d.copy()), torch.from_numpy(s.copy()))
                    for d, s in side) for side in pools_np]
    model = bind_params(PagedDecodeLM(dtype=torch.float32, quant=quant,
                                      all_logits=L > 1, **CFG), tparams)
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), tpools, torch.from_numpy(table),
                   torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert_pools_close(jpools, tpools)


# ---------------------------------------------------------------------------
# The int8 batcher against the JAX batcher
# ---------------------------------------------------------------------------

STATS = ("steps", "admits", "prefill_chunks", "prefix_hit_tokens",
         "prefix_hit_tokens_prompt", "prefix_hit_tokens_decode",
         "prefix_miss_tokens", "decode_pages_sealed", "seal_requants",
         "spec_steps", "spec_tokens", "draft_wraps")


@pytest.mark.parametrize("k", [None, 2], ids=["plain", "spec-k2"])
@pytest.mark.parametrize("policy", ["off", "quantized"])
def test_int8_batcher_matches_jax(jax_params, torch_params, k, policy):
    """Turn 1 over five requests, then a turn 2 extending request 0's
    stream (under "quantized" it hits sealed decode pages): streams,
    stats, pools and (speculating) the int8 draft ring as the JAX
    batcher's."""
    kw = dict(kv_dtype="int8", decode_page_cache=policy)
    jb = reference(jax_params, **kw,
                   **(spec_kw(jax_params, k) if k else {}))
    tb = port(torch_params, **kw, **(spec_kw(torch_params, k) if k else {}))
    rs = np.random.RandomState(0)
    prompts = traffic(rs)
    budgets = [9, 12, 5, 8, 11]
    for turn in (1, 2):
        if turn == 2:
            stream = [int(t) for t in prompts[0]] + want[0]
            prompts, budgets = [np.asarray(stream + [3], np.int32)], [6]
        want = jb.run([p.copy() for p in prompts], budgets)
        got = tb.run([p.copy() for p in prompts], budgets)
        assert got == want
        for key in STATS:
            assert tb.stats[key] == jb.stats[key], key
        tb.assert_page_accounting()
        # (the int8 draft rings are not compared: an idle lane scans
        # junk from ring row 0 here and from its stale head in the JAX
        # program, and the whole-lane requantization carries that junk
        # into the dead lane's scale until the next admission resets it)
        assert_pools_close(jb.pools, tb.pools)
    if policy == "quantized":
        assert tb.stats["prefix_hit_tokens_decode"] > 0


def test_int8_weights_batcher_matches_jax(jax_params):
    qjax = jax_quantize_params_int8(jax_params)
    qport = quantize_params_int8(params_from_numpy(
        jax.tree.map(np.asarray, jax_params)))
    rs = np.random.RandomState(3)
    prompts = traffic(rs, n=4)
    budgets = [7, 10, 6, 9]
    for kv in (None, "int8"):
        want = reference(qjax, quant=True, kv_dtype=kv).run(
            [p.copy() for p in prompts], budgets)
        tb = port(qport, quant=True, kv_dtype=kv)
        assert tb.run([p.copy() for p in prompts], budgets) == want
        tb.assert_page_accounting()


# ---------------------------------------------------------------------------
# Mirrors of tests/test_quantized_pool.py (the port alone)
# ---------------------------------------------------------------------------

def test_int8_pool_deterministic_and_agrees_with_fullwidth(torch_params):
    rs = np.random.RandomState(0)
    prompts = traffic(rs)
    budgets = [9, 12, 5, 8, 11]
    full = port(torch_params)
    q1 = port(torch_params, kv_dtype="int8")
    q2 = port(torch_params, kv_dtype="int8")
    out_f = full.run([p.copy() for p in prompts], budgets)
    out_1 = q1.run([p.copy() for p in prompts], budgets)
    assert out_1 == q2.run([p.copy() for p in prompts], budgets)
    for cb in (full, q1, q2):
        cb.assert_page_accounting()
    assert q1.kv_dtype == "int8" and full.kv_dtype == "float32"
    total = agree = 0
    for i in out_f:
        assert len(out_1[i]) == len(out_f[i])
        total += len(out_f[i])
        agree += sum(a == b for a, b in zip(out_f[i], out_1[i]))
    assert agree / total > 0.5, f"agreement collapsed: {agree}/{total}"


@pytest.mark.parametrize("page_size, spec", [(4, False), (8, True)])
def test_int8_multiturn_spec_churn_schedule(torch_params, page_size, spec):
    """Page sizes x speculation x multi-turn sealing x cancel/LRU churn:
    accounting (bytes leg included) at quiescent points, the turn-2
    prompt hits sealed decode pages, and the schedule replayed on a
    fresh batcher is token-identical."""
    kw = dict(kv_dtype="int8", decode_page_cache="quantized",
              page_size=page_size, pool_pages=46, station_slots=2,
              prompt_pad=24)
    if spec:
        kw.update(spec_kw(torch_params, k=2, draft_window=32))

    def run_schedule():
        cb = port(torch_params, **kw)
        rs = np.random.RandomState(13)
        outs = {}
        p0 = rs.randint(0, CFG["vocab_size"], size=11).astype(np.int32)
        outs.update(cb.run([p0], [8]))
        stream = [int(t) for t in p0] + outs[0]
        cb.submit(10, np.asarray(stream + [3], np.int32), 6)
        extra = traffic(rs, n=6, lo=4, hi=16)
        for j, p in enumerate(extra):
            cb.submit(20 + j, p, 7)
        cb.submit(99, extra[0].copy(), 9)
        stepped = 0
        while cb.has_work():
            outs.update(cb.serve_step())
            stepped += 1
            if stepped == 4:
                cb.cancel(99)
            if stepped % 7 == 0:
                cb.assert_page_accounting()
        cb.assert_page_accounting()
        return outs, dict(cb.stats)

    outs1, stats1 = run_schedule()
    outs2, _ = run_schedule()
    assert outs1 == outs2, "int8 schedule not deterministic"
    assert stats1["decode_pages_sealed"] > 0
    assert stats1["prefix_hit_tokens_decode"] > 0
    assert stats1["seal_requants"] > 0


def test_seal_time_requantization_leaves_tight_scales(torch_params):
    cb = port(torch_params, kv_dtype="int8", decode_page_cache="quantized",
              prompt_pad=24, **spec_kw(torch_params, k=2, draft_window=32))
    rs = np.random.RandomState(5)
    cb.run([rs.randint(0, CFG["vocab_size"], size=13).astype(np.int32)],
           [10])
    cb.assert_page_accounting()
    assert cb.stats["seal_requants"] > 0
    cached = sorted(cb.prefix_cache.pages())
    assert cached
    for kent, vent in cb.pools:
        for data, scale in (kent, vent):
            d = data[cached].abs().amax(dim=(2, 3))
            assert ((d == 127) | (scale[cached] == 0.0)).all()


def test_accounting_bytes_leg_catches_fullwidth_imposter(torch_params):
    cb = port(torch_params, kv_dtype="int8")
    cb.assert_page_accounting()
    (kd, ks), vent = cb.pools[0]
    cb.pools[0] = ((kd.float(), ks), vent)
    with pytest.raises(AssertionError):
        cb.assert_page_accounting()
    cb.pools[0] = ((kd, ks), vent)
    cb.assert_page_accounting()
    full = port(torch_params)
    kp, vp = full.pools[0]
    full.pools[0] = (kp.to(torch.bfloat16), vp)
    with pytest.raises(AssertionError):
        full.assert_page_accounting()
    # and the draft ring's leg
    spec = port(torch_params, kv_dtype="int8", **spec_kw(torch_params))
    spec.assert_page_accounting()
    (rd, rs_), rv = spec.d_caches[0]
    spec.d_caches[0] = ((rd.float(), rs_), rv)
    with pytest.raises(AssertionError):
        spec.assert_page_accounting()


def test_fresh_pages_start_with_clean_scales(torch_params):
    cb = port(torch_params, kv_dtype="int8", prefix_cache=False, slots=1,
              station_slots=1, pool_pages=5, prompt_pad=24)
    rs = np.random.RandomState(21)
    cb.run([rs.randint(0, CFG["vocab_size"], size=20).astype(np.int32)],
           [10])
    freed = sorted(cb.free_pages)
    assert cb.pools[0][0][1][freed].max() > 0, "vacuous: no stale scale"
    cb.submit(5, rs.randint(0, CFG["vocab_size"], size=6).astype(np.int32),
              10)
    cb.serve_step()
    s = next(s for s in cb._seqs if s.seq_id == 5)
    for kent, vent in cb.pools:
        for _, scale in (kent, vent):
            assert scale[s.pages[-1]].max() == 0.0
    while cb.has_work():
        cb.serve_step()
    cb.assert_page_accounting()


def test_reused_batcher_streams_identical_to_fresh(torch_params):
    rs = np.random.RandomState(22)
    prompts = traffic(rs, n=4, lo=5, hi=22)
    budgets = [10, 7, 12, 9]
    kw = dict(kv_dtype="int8", prefix_cache=False, slots=1,
              station_slots=1, pool_pages=6, prompt_pad=24)
    reused = port(torch_params, **kw)
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        got = reused.run([p.copy()], [b])
        assert got[0] == port(torch_params, **kw).run([p.copy()], [b])[0], (
            f"request {i}'s stream depends on allocation/station history")
        reused.assert_page_accounting()


# ---------------------------------------------------------------------------
# fp32 sealing (tests/test_multiturn_kv.py's two-turn case, small)
# ---------------------------------------------------------------------------

def test_fp32_two_turn_decode_page_hits_match_jax(jax_params, torch_params):
    """Turn 2 extends turn 1's stream through sealed DECODE pages on a
    full-width fp32 pool: the same tokens as the JAX batcher and as a
    cache-less port batcher, with the same hit split."""
    kw = dict(slots=2, prompt_pad=40, page_size=4, pool_pages=40,
              decode_page_cache="fp32")
    jb = reference(jax_params, **kw)
    tb = port(torch_params, **kw)
    rs = np.random.RandomState(1)
    turn1 = rs.randint(0, CFG["vocab_size"], size=6).astype(np.int32)
    out1 = tb.run([turn1], [10])[0]
    assert out1 == jb.run([turn1], [10])[0]
    assert tb.stats["decode_pages_sealed"] == jb.stats["decode_pages_sealed"]
    assert tb.stats["decode_pages_sealed"] > 0
    tb.assert_page_accounting()
    for extra in (1, 4):
        turn2 = np.concatenate([
            turn1, np.asarray(out1, np.int32),
            rs.randint(0, CFG["vocab_size"], size=extra).astype(np.int32)])
        cold = port(torch_params, **{**kw, "prefix_cache": False})
        got = tb.run([turn2], [5])[0]
        assert got == jb.run([turn2], [5])[0]
        assert got == cold.run([turn2], [5])[0]
        for key in ("prefix_hit_tokens_prompt", "prefix_hit_tokens_decode"):
            assert tb.stats[key] == jb.stats[key], key
        assert tb.stats["prefix_hit_tokens_decode"] > 0
        tb.assert_page_accounting()
