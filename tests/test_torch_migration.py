"""Live KV-page migration in the port (kubegpu_tpu_torch/models/paging.py)
against the JAX package, at float32 on the CPU.

- Across packages, both ways: a sequence exported mid-decode from a JAX
  batcher resumes in a port batcher and the reverse, on a full-width and
  an int8 pool, plain, greedy-speculative and seed-pinned
  sampled-speculative (whose draft-ring lane ships): the continuation
  equals the un-migrated JAX stream token for token; the two packages'
  payloads for the same state agree (keys, kinds, tokens, budget,
  sampling keys and ``layer_base`` equal; page bytes within 1e-5, or at
  int8 within one step and scales within 1e-5 relative, since each
  package prefilled its own pages); the importer's pool holds the
  payload's bytes exactly.
- Sampling keys: a pinned seed's ``base_key`` is the same two uint32
  words in both packages' payloads, for wide and negative seeds too.
- The JAX migration tests (tests/test_kv_migration.py) mirrored on the
  port: export is read-only and an orphaned export leaks nothing, a
  double import shares pages, an import into a chain with a hole shares
  the survivors, a refused import moves nothing (pool, cache,
  refcounts and device tensors byte-identical), unknown and mid-prefill
  sequences refuse export, and the sealed-chain round trip and the
  multi-turn restore hit the imported pages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy

# each package computes its own int8 scales from its own float32
# projections: they agree to tests/test_torch_quantized_pool.py's
# SCALE_RTOL (a few ulp), not bit for bit
SCALE_RTOL = 1e-5
# tests/test_kv_migration.py's model; a distinct 1-layer draft
CFG = dict(vocab_size=64, num_layers=2, num_heads=8, hidden=32, max_seq=64)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
KW = dict(slots=4, prompt_pad=32, page_size=4, pool_pages=48,
          decode_page_cache="fp32")
INT8 = dict(kv_dtype="int8", decode_page_cache="quantized")
SPEC = dict(speculate_k=2)
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
BUDGET = 20
SEED, TEMP = 7, 0.8

MODES = {
    "plain": {},
    "int8": INT8,
    "speculative": SPEC,
    "speculative-int8": dict(SPEC, **INT8),
    "sampled-speculative": dict(SPEC, sampling=True),
    "sampled-speculative-int8": dict(SPEC, sampling=True, **INT8),
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


def build(weights, side, **kw):
    jp, jd, tp, td = weights
    spec = "speculate_k" in kw
    kw = dict(KW, **kw)
    if side == "jax":
        return JaxPagedContinuousBatcher(
            jp, dtype=jnp.float32,
            **(dict(draft_params=jd, **DRAFT) if spec else {}), **CFG, **kw)
    return PagedContinuousBatcher(
        tp, dtype=torch.float32, device="cpu",
        **(dict(draft_params=td, **DRAFT) if spec else {}), **CFG, **kw)


def seq_of(cb, seq_id):
    return next(s for s in cb._seqs if s.seq_id == seq_id)


def drive_until(cb, seq_id, n_tokens, max_steps=200):
    """Step until the sequence committed >= n_tokens (still live);
    returns the steps taken."""
    for step in range(1, max_steps + 1):
        cb.serve_step()
        s = next((s for s in cb._seqs if s.seq_id == seq_id), None)
        if s is not None and s.active and len(s.tokens) >= n_tokens:
            return step
    raise AssertionError(f"seq {seq_id} never reached {n_tokens} tokens")


def drain(cb):
    done = {}
    while cb.has_work():
        done.update(cb.serve_step())
    return done


def submit_kw(mode):
    return (dict(temperature=TEMP, seed=SEED) if "sampled" in mode
            else {})


def pool_pages(cb, side, li, nm, phys):
    """Layer ``li``'s K (nm 0) or V (1) pages ``phys`` (and scales) of a
    batcher's pool, as numpy."""
    ent = cb.pools[li][nm]
    arrs = ent if isinstance(ent, tuple) else (ent,)
    if side == "jax":
        return [np.asarray(a)[np.asarray(phys)] for a in arrs]
    return [a[torch.tensor(phys)].numpy() for a in arrs]


def assert_payloads_agree(pj, pt, quant):
    for k in ("kind", "geometry", "prompt", "tokens", "remaining",
              "temperature", "base_key", "key_offset", "page_keys",
              "page_kinds", "layer_base"):
        assert pt[k] == pj[k], k
    for (jk, jv), (tk, tv) in zip(pj["layers"], pt["layers"]):
        for j, t in ((jk, tk), (jv, tv)):
            assert t.shape == j.shape and t.dtype == j.dtype
            if quant:
                assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    assert ("scales" in pt) == ("scales" in pj) == quant
    for (jk, jv), (tk, tv) in zip(pj.get("scales", []),
                                  pt.get("scales", [])):
        np.testing.assert_allclose(tk, jk, rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(tv, jv, rtol=SCALE_RTOL, atol=0)
    assert ("draft" in pt) == ("draft" in pj)
    if "draft" in pj:
        dj, dt = pj["draft"], pt["draft"]
        for k in ("d_pos", "window", "layers", "heads", "head_dim",
                  "dtype"):
            assert dt[k] == dj[k], k
        for (jk, jv), (tk, tv) in zip(dj["rows"], dt["rows"]):
            for j, t in ((jk, tk), (jv, tv)):
                assert t.shape == j.shape and t.dtype == j.dtype
                if quant:
                    assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
                else:
                    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
        for (jk, jv), (tk, tv) in zip(dj.get("scales", []),
                                      dt.get("scales", [])):
            np.testing.assert_allclose(tk, jk, rtol=SCALE_RTOL, atol=0)
            np.testing.assert_allclose(tv, jv, rtol=SCALE_RTOL, atol=0)


def assert_holds_payload(cb, side, seq_id, payload):
    """The importer's pool holds the payload's page bytes exactly."""
    s = seq_of(cb, seq_id)
    base = payload["layer_base"]
    phys = s.pages[base: base + payload["layers"][0][0].shape[0]]
    for li, (k_np, v_np) in enumerate(payload["layers"]):
        for nm, arr in ((0, k_np), (1, v_np)):
            got = pool_pages(cb, side, li, nm, phys)
            np.testing.assert_array_equal(got[0], arr)
            if "scales" in payload:
                np.testing.assert_array_equal(
                    got[1], payload["scales"][li][nm])


@pytest.mark.parametrize("mode", list(MODES))
def test_live_migration_across_packages(weights, mode):
    kw = MODES[mode]
    quant = "kv_dtype" in kw
    sub = submit_kw(mode)
    ref = build(weights, "jax", **kw).run(
        [PROMPT], [BUDGET], temperatures=[sub.get("temperature", 0.0)],
        seeds=[sub.get("seed")])[0]
    assert len(ref) == BUDGET
    payloads = {}
    for side in ("jax", "torch"):
        src = build(weights, side, **kw)
        src.submit(1, PROMPT, BUDGET, **sub)
        steps = drive_until(src, 1, 5)
        payloads[side] = src.export_pages(1)
        src.cancel(1)
        src.assert_page_accounting()
        payloads[side + "_steps"] = steps
    pj, pt = payloads["jax"], payloads["torch"]
    assert payloads["jax_steps"] == payloads["torch_steps"]
    assert pj["tokens"] == ref[: len(pj["tokens"])]
    assert_payloads_agree(pj, pt, quant)
    assert ("draft" in pt) == ("sampled" in mode)
    for payload, dst_side in ((pj, "torch"), (pt, "jax")):
        dst = build(weights, dst_side, **kw)
        dst.import_pages(11, payload)
        assert_holds_payload(dst, dst_side, 11, payload)
        dst.assert_page_accounting()
        assert drain(dst)[11] == ref, (mode, dst_side)
        assert dst.stats["imports"] == 1
        assert dst.stats["pages_imported"] == len(payload["page_keys"])
        dst.assert_page_accounting()


@pytest.mark.parametrize("seed", [7, -3, 2 ** 40 + 5, -(2 ** 62)])
def test_pinned_keys_cross_packages(weights, seed):
    """A pinned seed's base key is the same two uint32 words in both
    payloads, and the sampled continuation resumes at the absolute key
    index on the other package."""
    sub = dict(temperature=1.1, seed=seed)
    ref = build(weights, "jax").run([PROMPT], [12], temperatures=[1.1],
                                    seeds=[seed])[0]
    payloads = {}
    for side in ("jax", "torch"):
        src = build(weights, side)
        src.submit(1, PROMPT, 12, **sub)
        drive_until(src, 1, 4)
        payloads[side] = src.export_pages(1)
    pj, pt = payloads["jax"], payloads["torch"]
    assert pt["base_key"] == pj["base_key"]
    assert all(0 <= w < 2 ** 32 for w in pt["base_key"])
    assert pt["key_offset"] == pj["key_offset"] == len(PROMPT)
    for payload, dst_side in ((pj, "torch"), (pt, "jax")):
        dst = build(weights, dst_side)
        dst.import_pages(3, payload)
        assert drain(dst)[3] == ref


# ---------------------------------------------------------------------------
# the JAX migration tests, on the port
# ---------------------------------------------------------------------------

def jax_ref(weights, prompt, budget, **kw):
    return build(weights, "jax", **kw).run([prompt], [budget])[0]


def test_export_is_read_only_and_orphan_safe(weights):
    ref = jax_ref(weights, PROMPT, 15)
    src = build(weights, "torch")
    src.submit(2, PROMPT, 15)
    drive_until(src, 2, 4)
    payload = src.export_pages(2)
    src.assert_page_accounting()
    assert drain(src)[2] == ref              # no detach: it finishes
    src.assert_page_accounting()
    del payload                              # an orphaned export
    src.assert_page_accounting()


def test_double_import_shares_chain_pages(weights):
    ref = jax_ref(weights, PROMPT, 16)
    src = build(weights, "torch")
    dst = build(weights, "torch")
    src.submit(1, PROMPT, 16)
    drive_until(src, 1, 9)                   # past 2 full pages
    payload = src.export_pages(1)
    src.cancel(1)
    dst.import_pages(21, payload)
    dst.import_pages(22, payload)
    dst.assert_page_accounting()
    shared = [p for s in dst._seqs if s.seq_id in (21, 22)
              for p in s.shared]
    assert len(shared) > len(set(shared))
    # the second import writes only the private (keyless) tail page
    assert dst.stats["pages_imported"] == len(payload["page_keys"]) + sum(
        1 for k in payload["page_keys"] if k is None)
    out = drain(dst)
    assert out[21] == ref and out[22] == ref
    dst.assert_page_accounting()


def test_import_into_chain_with_a_hole(weights):
    ref = jax_ref(weights, PROMPT, 16)
    src = build(weights, "torch")
    dst = build(weights, "torch")
    src.submit(1, PROMPT, 16)
    drive_until(src, 1, 9)
    payload = src.export_pages(1)
    src.cancel(1)
    n_keys = sum(1 for k in payload["page_keys"] if k is not None)
    assert n_keys >= 2
    assert dst.import_sealed_chain(src.export_sealed_chain(
        payload["prompt"] + payload["tokens"])) > 0
    first = dst.prefix_cache.evict_lru()     # punch the hole: page 0
    assert first is not None
    dst.free_pages.add(first)
    dst.assert_page_accounting()
    dst.import_pages(30, payload)
    dst.assert_page_accounting()
    assert len(seq_of(dst, 30).shared) >= n_keys - 1
    assert drain(dst)[30] == ref
    dst.assert_page_accounting()


def device_state(cb):
    """Everything a refused import must leave byte-identical."""
    tensors = [t.clone() for kent, vent in cb.pools
               for ent in (kent, vent)
               for t in (ent if isinstance(ent, tuple) else (ent,))]
    tensors += [t.clone() for t in (
        cb._tables_dev, cb._pos_dev, cb._last_dev, cb._active_dev,
        cb._remaining_dev, cb._counts_dev, cb._temps, cb._base_keys,
        cb._key_offsets)]
    cache = cb.prefix_cache
    host = (sorted(cb.free_pages), dict(cache._entries), dict(cache._refs),
            [(s.seq_id, list(s.pages), set(s.shared)) for s in cb._seqs],
            dict(cb.stats), cb.tables.copy(), cb.pos.copy())
    return tensors, host


def assert_unchanged(cb, before):
    tensors, host = device_state(cb)
    for a, b in zip(tensors, before[0]):
        assert torch.equal(a, b)
    (free, entries, refs, seqs, stats, tables, pos) = host
    (free0, entries0, refs0, seqs0, stats0, tables0, pos0) = before[1]
    assert (free, entries, refs, seqs, stats) == (free0, entries0, refs0,
                                                  seqs0, stats0)
    assert (tables == tables0).all() and (pos == pos0).all()


@pytest.mark.parametrize("quant", [False, True])
def test_import_refusal_is_atomic(weights, quant):
    kw = INT8 if quant else {}
    src = build(weights, "torch", **kw)
    src.submit(1, PROMPT, 12)
    drive_until(src, 1, 4)
    payload = src.export_pages(1)

    # no free slot
    dst = build(weights, "torch", slots=1, **kw)
    dst.submit(9, np.array([7, 7, 7], np.int32), 30)
    drive_until(dst, 9, 1)
    before = device_state(dst)
    with pytest.raises(RuntimeError, match="no free sequence slot"):
        dst.import_pages(40, payload)
    assert_unchanged(dst, before)
    dst.assert_page_accounting()

    # a payload that can never fit the pool: ValueError
    never = build(weights, "torch", pool_pages=4, **kw)
    before = device_state(never)
    with pytest.raises(ValueError, match="pages"):
        never.import_pages(41, payload)
    assert_unchanged(never, before)

    # pool pressure: a retriable refusal
    tiny = build(weights, "torch", pool_pages=8, **kw)
    tiny.submit(1, np.array([7, 7, 7], np.int32), 12)
    drive_until(tiny, 1, 1)
    before = device_state(tiny)
    with pytest.raises(RuntimeError, match="import refused"):
        tiny.import_pages(41, payload)
    assert_unchanged(tiny, before)
    drain(tiny)
    tiny.assert_page_accounting()

    # a hole below layer_base, bad shapes, a wrong array type and a
    # geometry mismatch: refused with nothing moved
    other = build(weights, "torch", **kw)
    before = device_state(other)
    holed = dict(payload, layer_base=1,
                 layers=[(k[1:], v[1:]) for k, v in payload["layers"]])
    if quant:
        holed["scales"] = [(k[1:], v[1:]) for k, v in payload["scales"]]
    with pytest.raises(RuntimeError, match="below layer_base"):
        other.import_pages(42, holed)
    with pytest.raises(ValueError, match="shape"):
        other.import_pages(42, dict(payload, layers=[
            (k[:1], v[:1]) for k, v in payload["layers"]]))
    with pytest.raises(ValueError, match="cannot hold"):
        other.import_pages(42, dict(payload, layers=[
            (k.astype(np.int16), v.astype(np.int16))
            for k, v in payload["layers"]]))
    if quant:
        with pytest.raises(ValueError, match="scale"):
            other.import_pages(42, dict(payload, scales=[
                (k[:, :1], v[:, :1]) for k, v in payload["scales"]]))
    with pytest.raises(ValueError, match="geometry mismatch"):
        build(weights, "torch", page_size=8, **kw).import_pages(42,
                                                                payload)
    assert_unchanged(other, before)
    other.assert_page_accounting()
    src.assert_page_accounting()


def test_export_rejects_unknown_and_mid_prefill(weights):
    cb = build(weights, "torch")
    with pytest.raises(KeyError):
        cb.export_pages(123)
    cb.submit(3, np.arange(1, 13, dtype=np.int32), 8)
    cb.serve_step()
    assert seq_of(cb, 3).prefilling
    with pytest.raises(ValueError, match="mid-prefill"):
        cb.export_pages(3)
    drain(cb)
    cb.assert_page_accounting()
    # a finished sequence is gone; a zero-budget one has nothing to move
    with pytest.raises(KeyError):
        cb.export_pages(3)


def test_sealed_chain_restore_roundtrip(weights):
    """Capture turn 1's sealed chain on the port, import it into a cold
    port replica and a cold JAX replica: turn 2 there hits the decode
    region and equals the stayed-home turn 2."""
    src = build(weights, "torch")
    t1 = src.run([PROMPT], [9])[0]
    assert t1 == jax_ref(weights, PROMPT, 9)
    stream = [int(t) for t in PROMPT] + t1
    payload = src.export_sealed_chain(stream)
    assert payload is not None
    assert len(payload["page_keys"]) == (len(stream) - 1) // 4
    p2 = np.asarray(stream + [13], np.int32)
    ref = src.run([p2], [6])[0]
    for side in ("torch", "jax"):
        dst = build(weights, side)
        assert dst.import_sealed_chain(payload) == len(payload["page_keys"])
        dst.assert_page_accounting()
        assert dst.import_sealed_chain(payload) == 0     # dedup
        assert dst.run([p2], [6])[0] == ref
        assert dst.stats["prefix_hit_tokens_decode"] > 0
        dst.assert_page_accounting()
    # and a JAX capture into the port
    jsrc = build(weights, "jax")
    jsrc.run([PROMPT], [9])
    dst = build(weights, "torch")
    assert dst.import_sealed_chain(jsrc.export_sealed_chain(stream)) > 0
    assert dst.run([p2], [6])[0] == ref
    assert dst.stats["prefix_hit_tokens_decode"] > 0
    src.assert_page_accounting()


def test_multiturn_sealed_migration(weights):
    """Turn 1 seals on the source; a turn-2 sequence whose admission
    hits the sealed chain migrates mid-decode and finishes equal to the
    never-migrated turn 2; the importer is warm for a third turn."""
    src = build(weights, "torch")
    dst = build(weights, "torch")
    t1 = src.run([PROMPT], [7])[0]
    stream = [int(t) for t in PROMPT] + t1
    p2 = np.asarray(stream[:14] + [11], np.int32)
    ref = jax_ref(weights, p2, 8)
    assert src.run([p2], [8])[0] == ref
    src.submit(5, p2, 8)
    drive_until(src, 5, 3)
    payload = src.export_pages(5)
    src.cancel(5)
    dst.import_pages(50, payload)
    assert drain(dst)[50] == ref
    src.assert_page_accounting()
    dst.assert_page_accounting()
    dst.run([np.asarray(stream[:12], np.int32)], [4])
    assert dst.stats["prefix_hit_tokens"] > 0


def test_migrated_trace_opens_an_imported_subtree(weights):
    from kubegpu_tpu_torch.utils.tracing import Tracer

    src = build(weights, "torch")
    tracer = Tracer()
    dst = build(weights, "torch", tracer=tracer)
    src.submit(1, PROMPT, 10)
    drive_until(src, 1, 3)
    dst.import_pages(4, src.export_pages(1))
    drain(dst)
    spans = [sp for t in tracer.completed() for sp in t]
    serve = [sp for sp in spans if sp["name"] == "serve"]
    assert len(serve) == 1 and serve[0]["attrs"]["imported"] is True
    names = {sp["name"] for sp in spans}
    assert {"queue", "decode"} <= names and "prefill" not in names
