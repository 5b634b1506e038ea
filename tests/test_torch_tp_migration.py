"""Live KV-page migration at tensor parallelism in the port, against the
JAX package's ``tests/test_kv_migration.py`` TP cases, at float32 on the
CPU.

A payload does not depend on the layout: an export gathers the ranks'
head shards in head order, and an import gives each rank its heads.  So
a sequence exported mid-decode continues token for token as the stream
that never migrated, whatever the two ends' widths and packages: port
TP 2 to port TP 2 (two batchers of one gang), TP 2 to TP 1, TP 1 to
TP 2, JAX TP 2 to port TP 2 and port TP 2 to JAX TP 2 and TP 1, on a
full-width and an int8 pool, greedy-speculative, and seed-pinned
sampled-speculative (whose draft-ring lane ships).  The page accounting
balances on both ends (every rank's host state checked against rank
0's), and the TP 2 payload equals the JAX TP 2 payload for the same
state (keys, kinds, tokens, sampling keys equal, the geometry's ``tp``
2; pages within 1e-5, int8 within one step).  The port's TP 2 ranks run
in one gang of JAX-free processes over gloo (rank bodies in
``tests/torch_tp_cases.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.parallel import device_mesh
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.parallel.launch import Gang
import torch_tp_cases as cases

# tests/test_torch_migration.py's model and pool; the draft's 2 heads
# split over 2 ranks
CFG = dict(vocab_size=64, num_layers=2, num_heads=8, hidden=32, max_seq=64)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
KW = dict(slots=4, prompt_pad=32, page_size=4, pool_pages=48,
          decode_page_cache="fp32")
INT8 = dict(kv_dtype="int8", decode_page_cache="quantized")
SPEC = dict(speculate_k=2)
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
BUDGET = 20
AFTER = 5
SEED, TEMP = 7, 0.8
GANG_TIMEOUT_S = 300.0

MODES = {
    "plain": {},
    "int8": INT8,
    "speculative": SPEC,
    "sampled-speculative": dict(SPEC, sampling=True),
}


@pytest.fixture(scope="module")
def weights():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    jd = TransformerLM(
        vocab_size=CFG["vocab_size"], max_seq=CFG["max_seq"], num_layers=1,
        num_heads=2, hidden=16, dtype=jnp.float32,
    ).init(jax.random.PRNGKey(7), jnp.ones((2, 8), jnp.int32))["params"]
    return (jp, jd, jax.tree.map(np.asarray, jp),
            jax.tree.map(np.asarray, jd))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(2, str(tmp_path_factory.mktemp("tp2mig")), backend="gloo",
             devices=["cpu"] * 2, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


def run_kw(mode):
    return dict(temperature=TEMP, seed=SEED) if "sampled" in mode else {}


def spec_of(weights, mode):
    """The gang's batcher spec for ``mode``."""
    _, _, np_p, np_d = weights
    kw = dict(KW, **MODES[mode])
    spec = "speculate_k" in kw
    if spec:
        kw.update(DRAFT)
    return dict(params=np_p, cfg=CFG, kw=kw, draft=np_d if spec else None)


def jax_cb(weights, mode, tp):
    jp, jd = weights[:2]
    kw = dict(KW, **MODES[mode])
    if "speculate_k" in kw:
        kw.update(DRAFT, draft_params=jd)
    mesh = (device_mesh({"model": tp}, devices=jax.devices()[:tp])
            if tp > 1 else None)
    return JaxPagedContinuousBatcher(jp, dtype=jnp.float32, mesh=mesh,
                                     **CFG, **kw)


def port_cb(weights, mode):
    np_p, np_d = weights[2:]
    kw = dict(KW, **MODES[mode])
    if "speculate_k" in kw:
        kw.update(DRAFT, draft_params=params_from_numpy(np_d))
    return PagedContinuousBatcher(params_from_numpy(np_p),
                                  dtype=torch.float32, device="cpu", **CFG,
                                  **kw)


def unmigrated(weights, mode):
    sub = run_kw(mode)
    out = port_cb(weights, mode).run(
        [PROMPT], [BUDGET], temperatures=[sub.get("temperature", 0.0)],
        seeds=[sub.get("seed")])[0]
    assert len(out) == BUDGET
    return out


def export_in_process(cb, mode):
    cb.submit(1, PROMPT, BUDGET, **run_kw(mode))
    for _ in range(200):
        cb.serve_step()
        s = next((s for s in cb._seqs if s.seq_id == 1), None)
        if s is not None and s.active and len(s.tokens) >= AFTER:
            break
    payload = cb.export_pages(1)
    cb.cancel(1)
    cb.assert_page_accounting()
    return payload


def import_in_process(cb, payload):
    cb.import_pages(10, payload)
    done = {}
    while cb.has_work():
        done.update(cb.serve_step())
    cb.assert_page_accounting()
    return done[10]


def gang_export(gang, weights, mode):
    return gang.run(cases.export_mid_stream, spec_of(weights, mode), PROMPT,
                    BUDGET, AFTER, run_kw(mode))


def gang_import(gang, weights, mode, payload):
    return gang.run(cases.import_and_drain, spec_of(weights, mode),
                    payload)["stream"]


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_to_tp2(gang, weights, mode):
    got = gang.run(cases.migrate_within, spec_of(weights, mode),
                   spec_of(weights, mode), PROMPT, BUDGET, AFTER,
                   run_kw(mode))
    assert got["stream"] == unmigrated(weights, mode)
    assert got["geometry"]["tp"] == 2
    assert got["draft"] == ("sampled" in mode)


@pytest.mark.parametrize("mode", ["plain", "int8", "sampled-speculative"])
def test_tp2_to_tp1(gang, weights, mode):
    payload = gang_export(gang, weights, mode)
    assert payload["geometry"]["tp"] == 2
    got = import_in_process(port_cb(weights, mode), payload)
    assert got == unmigrated(weights, mode)


@pytest.mark.parametrize("mode", ["plain", "int8", "sampled-speculative"])
def test_tp1_to_tp2(gang, weights, mode):
    payload = export_in_process(port_cb(weights, mode), mode)
    assert payload["geometry"]["tp"] == 1
    assert gang_import(gang, weights, mode, payload) == unmigrated(
        weights, mode)


def assert_payloads_agree(pj, pt, quant):
    for k in ("kind", "prompt", "tokens", "remaining", "temperature",
              "base_key", "key_offset", "page_keys", "page_kinds",
              "layer_base", "geometry"):
        assert pt[k] == pj[k], k
    pairs = list(zip(pj["layers"], pt["layers"]))
    if "draft" in pj:
        pairs += list(zip(pj["draft"]["rows"], pt["draft"]["rows"]))
    for (jk, jv), (tk, tv) in pairs:
        for j, t in ((jk, tk), (jv, tv)):
            assert t.shape == j.shape and t.dtype == j.dtype
            if quant:
                assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "int8", "sampled-speculative"])
def test_jax_tp2_to_torch_tp2_and_back(gang, weights, mode):
    """JAX TP 2 -> port TP 2, and port TP 2 -> JAX TP 2 and JAX TP 1:
    each continues the un-migrated stream, and the two TP 2 payloads of
    one state agree."""
    ref = unmigrated(weights, mode)
    pj = export_in_process(jax_cb(weights, mode, 2), mode)
    assert pj["geometry"]["tp"] == 2
    assert gang_import(gang, weights, mode, pj) == ref
    pt = gang_export(gang, weights, mode)
    assert_payloads_agree(pj, pt, "kv_dtype" in MODES[mode])
    assert import_in_process(jax_cb(weights, mode, 2), pt) == ref
    assert import_in_process(jax_cb(weights, mode, 1), pt) == ref


def test_tp2_prefill_only_handoff_to_tp1(gang, weights):
    """A TP 2 prefill-only source parks the prompt at its seal; rank 0
    announces it once (the other ranks record no seal, so the drain
    needs no collective), and its parked export continues in a TP 1
    batcher as the stream that never migrated."""
    got = gang.run(cases.park_and_export, spec_of(weights, "plain"),
                   PROMPT, BUDGET)
    assert got["sealed"] == [1] and got["again"] == []
    assert got["pending"] == [[], []]
    payload = got["payload"]
    assert payload["geometry"]["tp"] == 2 and payload["tokens"] == []
    got = import_in_process(port_cb(weights, "plain"), payload)
    assert got == unmigrated(weights, "plain")


def test_geometry_refusal_says_tp_may_differ(gang, weights):
    """Only the layout's tp may differ: a payload of other heads is
    refused, and the refusal says so."""
    payload = gang_export(gang, weights, "plain")
    payload["geometry"] = dict(payload["geometry"], heads=4)
    with pytest.raises(ValueError, match="tp may differ"):
        port_cb(weights, "plain").import_pages(10, payload)
