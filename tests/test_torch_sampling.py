"""The port's sampling against the JAX package's, on the CPU.

- ``kubegpu_tpu_torch/ops/prng.py`` against ``jax.random`` (JAX 0.9,
  partitionable threefry, 64-bit mode off): ``PRNGKey``, ``fold_in``,
  ``split``, 32-bit ``random_bits``, ``uniform`` and the seed-pinned
  ``position_key``/``block_keys`` bit for bit, over a grid of seeds,
  positions, tags and shapes; seeds at and above 2**31, negative seeds
  and out-of-range values behave as JAX's.
- Gumbel noise: each of its two logs within 1 ulp of XLA's, the noise
  within 2 ulp at its own scale (the spacing of max(|g|, 1): near g = 0
  one ulp of the inner log is an absolute error of about 2**-24).
  ``categorical`` and ``pick_tokens`` identical on a seeded grid of
  temperatures, ``top_k`` (0, 1, 5) and mixed greedy/sampled rows; a
  differing draw must be a near-tie: the two highest perturbed scores
  (warped logit + gumbel) within ``NEAR_TIE`` = 1e-4.
- ``rejection_sample_block``: the chi-square marginal gate at alpha =
  0.001 for the accept path, the residual path and the bonus slot, the
  rejected token never resampled where the draft over-proposes (mirrors
  of tests/test_sampled_spec.py), and block and accept counts equal to
  JAX's for the same keys.
- Dense decoding at float32: ``generate(temperature, top_k, rng)`` and
  ``speculative_generate(temperatures, seeds, top_k)`` token-identical
  to JAX's; the seed-pinned grid (a pinned row is the same alone or in a
  batch, another seed changes it), ``top_k=1`` degenerating to greedy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models import decoding as jdec
from kubegpu_tpu.models import speculative as jspec
from kubegpu_tpu_torch.models import decoding as tdec
from kubegpu_tpu_torch.models import speculative as tspec
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.ops import prng

NEAR_TIE = 1e-4          # top-2 perturbed-score gap that may flip a draw
SEEDS = (0, 1, 7, 2 ** 31 - 1)
SHAPES = ((7,), (3, 32000), (2, 5, 513))
# with 64-bit mode off JAX keeps the low 32 bits of any int64 seed
WIDE_SEEDS = (2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40 + 3,
              2 ** 63 - 1, -1, -5, -2 ** 31, -2 ** 31 - 1, -2 ** 40)
CFG = dict(vocab_size=61, num_layers=2, num_heads=4, hidden=32, max_seq=64)
DRAFT = dict(draft_num_layers=1, draft_num_heads=2, draft_hidden=16)


def jkey(seed):
    return jax.random.PRNGKey(seed)


def as_port(keys):
    """JAX uint32 keys as the port's int64 words."""
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


# ---------------------------------------------------------------------------
# the PRNG, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS + WIDE_SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(jkey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", [2 ** 63, 2 ** 64, -2 ** 63 - 1])
def test_seeds_outside_int64_overflow_as_in_jax(seed):
    with pytest.raises(OverflowError):
        jkey(seed)
    with pytest.raises(OverflowError):
        prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS + (2 ** 40 + 3, -1))
def test_fold_in_and_split_match_jax(seed):
    k, tk = jkey(seed), prng.PRNGKey(seed)
    for data in (0, 1, 5, 129, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            np.asarray(jax.random.fold_in(k, data)).astype(np.int64))
    for num in (2, 7, (3, 4)):
        np.testing.assert_array_equal(
            prng.split(tk, num).numpy(),
            np.asarray(jax.random.split(k, num)).astype(np.int64))
    # batched: one fold per key, int32 data wrapped to uint32 as JAX
    # converts it
    keys = jax.random.split(k, 6)
    data = np.array([0, 3, -1, 2 ** 31 - 1, -2 ** 31, 77], np.int32)
    np.testing.assert_array_equal(
        prng.fold_in(as_port(keys), torch.from_numpy(data)).numpy(),
        np.asarray(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data))
                   ).astype(np.int64))


def test_fold_in_refuses_ints_outside_uint32_as_jax_does():
    for data in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jkey(0), data)
        with pytest.raises(OverflowError):
            prng.fold_in(prng.PRNGKey(0), data)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_match_jax(seed, shape):
    k, tk = jkey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(k, shape)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))
    # bounds whose span is not 1: XLA fuses the scale and the shift
    np.testing.assert_array_equal(
        prng.uniform(tk, shape, -2.5, 3.3).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=-2.5, maxval=3.3)))


def test_batched_keys_draw_as_jax_vmap_does():
    keys = jax.random.split(jkey(3), 5)
    np.testing.assert_array_equal(
        prng.random_bits(as_port(keys), (3, 33)).numpy(),
        np.asarray(jax.vmap(lambda kk: jax.random.bits(kk, (3, 33)))(keys)
                   ).astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform(as_port(keys)).numpy(),
        np.asarray(jax.vmap(jax.random.uniform)(keys)))


@pytest.mark.parametrize("tag", [jdec.KEY_TAG_DRAFT, jdec.KEY_TAG_ACCEPT,
                                 jdec.KEY_TAG_SAMPLE, 7])
def test_position_and_block_keys_match_jax(tag):
    seeds = [0, 1, 7, 2 ** 31 - 1, 41]
    base = jnp.stack([jkey(s) for s in seeds])
    tbase = torch.stack([prng.PRNGKey(s) for s in seeds])
    for pos in (0, 3, 128, 4095):
        want = jax.vmap(jdec.position_key, in_axes=(0, None, None))(
            base, pos, tag)
        got = tdec.position_key(tbase, pos, tag)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    start = np.array([0, 5, 17, 300, 2 ** 20], np.int32)
    for n in (1, 3, 9):
        want = jdec.block_keys(base, jnp.asarray(start), n, tag)
        got = tdec.block_keys(tbase, torch.from_numpy(start), n, tag)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def test_window_keys_are_the_three_tagged_blocks():
    base = jnp.stack([jkey(s) for s in (4, 9, 2 ** 31 - 1)])
    pos = np.array([7, 0, 200], np.int32)
    d, a, s = tspec.window_keys(as_port(base), torch.from_numpy(pos), 3)
    for got, tag, n in ((d, jdec.KEY_TAG_DRAFT, 4),
                        (a, jdec.KEY_TAG_ACCEPT, 3),
                        (s, jdec.KEY_TAG_SAMPLE, 4)):
        want = jdec.block_keys(base, jnp.asarray(pos) + 1, n, tag)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# gumbel noise and categorical draws
# ---------------------------------------------------------------------------

def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gumbel_within_two_ulp(shape):
    k, tk = jkey(11), prng.PRNGKey(11)
    u = np.array(jax.random.uniform(k, shape,
                                    minval=np.finfo(np.float32).tiny))
    inner = np.array(jnp.log(jnp.asarray(u)))
    assert ulps(torch.log(torch.from_numpy(u)).numpy(), inner).max() <= 1
    y = -inner
    assert ulps(torch.log(torch.from_numpy(y)).numpy(),
                np.asarray(jnp.log(jnp.asarray(y)))).max() <= 1
    want = np.asarray(jax.random.gumbel(k, shape))
    got = prng.gumbel(tk, shape).numpy()
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * scale).all()


def near_tie(scores, rows):
    """Assert every row of ``rows`` has its two highest perturbed scores
    within NEAR_TIE (a draw rounding may flip)."""
    for r in rows:
        top2 = np.sort(scores[r])[-2:]
        assert top2[1] - top2[0] <= NEAR_TIE, (r, top2)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    rng = np.random.RandomState(seed % 1000)
    logits = (rng.randn(6, 4096) * 2).astype(np.float32)
    k, tk = jkey(seed), prng.PRNGKey(seed)
    # one key over the whole (b, vocab) array, as dense generate draws
    want = np.asarray(jax.random.categorical(k, logits))
    got = prng.categorical(tk, torch.from_numpy(logits)).numpy()
    scores = np.asarray(jax.random.gumbel(k, logits.shape)) + logits
    near_tie(scores, np.nonzero(got != want)[0])
    # one key per row, as the serving batchers draw
    keys = jax.random.split(k, 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(as_port(keys), torch.from_numpy(logits)).numpy()
    scores = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
        kk, (4096,)))(keys)) + logits
    near_tie(scores, np.nonzero(got != want)[0])


@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_pick_tokens_matches_jax(seed, top_k):
    rng = np.random.RandomState(seed)
    b, v = 12, 997
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    # a tie at the 5th value: top_k keeps every logit >= the k-th
    logits[0, :6] = logits[0].max() + 1.0
    temps = np.array([0.0, 0.7, 1.0, 0.0, 2.0, 0.3, 1.3, 0.0, 0.9, 5.0,
                      0.05, 1.1], np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b) + 100 * seed)
    want = np.asarray(jdec.pick_tokens(jnp.asarray(logits),
                                       jnp.asarray(temps), keys, top_k))
    got = tdec.pick_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                           as_port(keys), top_k)
    assert got.dtype == torch.int32
    got = got.numpy()
    warped = np.asarray(jdec.warp_logits(jnp.asarray(logits),
                                         jnp.asarray(temps), top_k))
    np.testing.assert_array_equal(
        tdec.warp_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                         top_k).numpy(), warped)
    scores = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
        kk, (v,)))(keys)) + warped
    near_tie(scores, np.nonzero(got != want)[0])
    greedy = temps == 0
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    if top_k == 1:
        np.testing.assert_array_equal(got, logits.argmax(-1))


# ---------------------------------------------------------------------------
# the rejection sampler
# ---------------------------------------------------------------------------

# chi-square critical values at alpha = 0.001 (tests/test_sampled_spec.py)
_CHI2_999 = {5: 20.5, 6: 22.5, 7: 24.3}


def _chi_square(counts, probs):
    expected = probs * counts.sum()
    mask = expected > 0
    return float(((counts[mask] - expected[mask]) ** 2
                  / expected[mask]).sum())


def _run_block(t_logits, d_logits, n, k, seed=0):
    """The port's twin of tests/test_sampled_spec.py's ``_run_block``:
    propose from q with per-row draft keys, then rejection-sample; the
    (n, k+1) block, the accept counts and the proposals."""
    v = t_logits.shape[-1]
    base = torch.stack([prng.PRNGKey(i + seed * 1_000_003)
                        for i in range(n)])
    start = torch.zeros((n,), dtype=torch.int64)
    dkeys = tdec.block_keys(base, start, k, 7)
    proposals = prng.categorical(dkeys, d_logits.expand(n, k, v))
    a_keys = tdec.block_keys(base, start, k, tdec.KEY_TAG_ACCEPT)
    s_keys = tdec.block_keys(base, start, k + 1, tdec.KEY_TAG_SAMPLE)
    block, accepted = tspec.rejection_sample_block(
        t_logits.expand(n, k + 1, v), d_logits.expand(n, k, v), proposals,
        a_keys, s_keys)
    return block.numpy(), accepted.numpy(), proposals.numpy()


def test_rejection_sampler_matches_target_softmax():
    """Position 0's marginal is the target softmax under a disagreeing
    draft, through the accept and the residual path alike; the bonus
    slot's too (chi-square, alpha = 0.001)."""
    v, k, n = 7, 2, 40_000
    rng = np.random.RandomState(5)
    t_logits = torch.from_numpy((rng.randn(v) * 1.5).astype(np.float32))
    d_logits = torch.from_numpy((rng.randn(v) * 1.5).astype(np.float32))
    p = torch.softmax(t_logits, -1).numpy().astype(np.float64)
    block, accepted, _ = _run_block(t_logits, d_logits, n, k)
    assert (accepted == 0).sum() > n // 20, "residual path starved"
    assert (accepted > 0).sum() > n // 20, "accept path starved"
    chi2 = _chi_square(np.bincount(block[:, 0], minlength=v), p)
    assert chi2 < _CHI2_999[v - 1], chi2
    full = block[accepted >= k]
    assert len(full) > n // 20
    chi2_bonus = _chi_square(np.bincount(full[:, k], minlength=v), p)
    assert chi2_bonus < _CHI2_999[v - 1], chi2_bonus


def test_rejection_residual_never_replays_the_rejected_token():
    """Where the draft over-proposes (q > p), a rejection resamples from
    max(0, p - q): the rejected token has no residual mass there."""
    v, k, n = 6, 1, 30_000
    t_logits = torch.zeros(v)
    d_logits = torch.tensor([4.0] + [0.0] * (v - 1))
    block, accepted, proposals = _run_block(t_logits, d_logits, n, k, seed=1)
    rejected = accepted == 0
    assert rejected.sum() > n // 10
    over = rejected & (proposals[:, 0] == 0)
    assert over.sum() > n // 20
    assert (block[over, 0] != 0).all()
    p = np.full(v, 1.0 / v)
    chi2 = _chi_square(np.bincount(block[:, 0], minlength=v), p)
    assert chi2 < _CHI2_999[v - 1], chi2


@pytest.mark.parametrize("k", [1, 2, 4])
def test_rejection_block_matches_jax_for_the_same_keys(k):
    rng = np.random.RandomState(k)
    n, v = 1500, 9
    t = (rng.randn(n, k + 1, v) * 1.5).astype(np.float32)
    d = (rng.randn(n, k, v) * 1.5).astype(np.float32)
    proposals = rng.randint(0, v, size=(n, k)).astype(np.int32)
    base = jax.vmap(jax.random.PRNGKey)(jnp.arange(n))
    zero = jnp.zeros((n,), jnp.int32)
    a_keys = jdec.block_keys(base, zero, k, jdec.KEY_TAG_ACCEPT)
    s_keys = jdec.block_keys(base, zero, k + 1, jdec.KEY_TAG_SAMPLE)
    jb, ja = jspec.rejection_sample_block(
        jnp.asarray(t), jnp.asarray(d), jnp.asarray(proposals), a_keys,
        s_keys)
    tb, ta = tspec.rejection_sample_block(
        torch.from_numpy(t), torch.from_numpy(d), torch.from_numpy(proposals),
        as_port(a_keys), as_port(s_keys))
    assert tb.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# ---------------------------------------------------------------------------
# dense decoding at float32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = TransformerLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(0), jnp.ones((2, 8), jnp.int32))["params"]
    jd = TransformerLM(vocab_size=CFG["vocab_size"], num_layers=1,
                       num_heads=2, hidden=16, max_seq=CFG["max_seq"],
                       dtype=jnp.float32).init(
        jax.random.PRNGKey(3), jnp.ones((2, 8), jnp.int32))["params"]

    def to_torch(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree))

    return jp, jd, to_torch(jp), to_torch(jd)


@pytest.mark.parametrize("temperature, top_k, seed", [
    (0.8, 0, 0), (1.3, 5, 7), (0.5, 1, 2 ** 31 - 1), (2.0, 0, 1)])
def test_generate_sampled_matches_jax(weights, temperature, top_k, seed):
    jp, _, tp, _ = weights
    prompt = np.random.RandomState(seed % 97).randint(
        0, CFG["vocab_size"], size=(3, 5)).astype(np.int32)
    want = np.asarray(jdec.generate(
        jp, jnp.asarray(prompt), 20, dtype=jnp.float32,
        temperature=temperature, top_k=top_k, rng=jkey(seed), **CFG))
    got = tdec.generate(tp, torch.from_numpy(prompt), 20,
                        dtype=torch.float32, temperature=temperature,
                        top_k=top_k, rng=prng.PRNGKey(seed), device="cpu",
                        **CFG)
    np.testing.assert_array_equal(got.numpy(), want)
    if top_k == 1:
        greedy = tdec.greedy_generate(tp, torch.from_numpy(prompt), 20,
                                      dtype=torch.float32, device="cpu",
                                      **CFG)
        np.testing.assert_array_equal(got.numpy(), greedy.numpy())


TEMPS = [0.9, 0.0, 1.2, 0.8]
PINS = [41, 5, 42, 43]


def spec_pair(weights, prompt, steps, k=3, **kw):
    """The same sampled speculative decode through JAX and the port."""
    jp, jd, tp, td = weights
    want, want_calls = jspec.speculative_generate(
        jp, jd, jnp.asarray(prompt), steps, k=k, dtype=jnp.float32, **kw,
        **DRAFT, **CFG)
    got, calls = tspec.speculative_generate(
        tp, td, prompt, steps, k=k, dtype=torch.float32, device="cpu", **kw,
        **DRAFT, **CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == int(want_calls)
    return got.numpy()


@pytest.mark.parametrize("k, top_k", [(1, 0), (3, 0), (2, 5)])
def test_speculative_generate_sampled_matches_jax(weights, k, top_k):
    prompt = np.random.RandomState(k).randint(
        0, CFG["vocab_size"], size=(4, 5)).astype(np.int32)
    spec_pair(weights, prompt, 20, k=k, temperatures=TEMPS, seeds=PINS,
              top_k=top_k)


def test_speculative_generate_seed_pinned_grid(weights):
    """A pinned stream is THE stream: the same row alone or in a batch,
    another seed changes it, no seeds means the row index, and the
    greedy row rides along unchanged (mirror of
    tests/test_sampled_spec.py's seed-pinned grid, in both packages)."""
    prompt = np.random.RandomState(9).randint(
        0, CFG["vocab_size"], size=(4, 6)).astype(np.int32)
    ref = spec_pair(weights, prompt, 16, temperatures=TEMPS, seeds=PINS)
    solo = spec_pair(weights, prompt[2:3], 16, temperatures=[TEMPS[2]],
                     seeds=[PINS[2]])
    np.testing.assert_array_equal(solo[0], ref[2])
    other = spec_pair(weights, prompt[2:3], 16, temperatures=[TEMPS[2]],
                      seeds=[777])
    assert (other[0] != ref[2]).any()
    _, _, tp, td = weights
    default, explicit = (tspec.speculative_generate(
        tp, td, prompt, 16, k=3, dtype=torch.float32, device="cpu",
        temperatures=TEMPS, **kw, **DRAFT, **CFG)[0]
        for kw in ({}, dict(seeds=[0, 1, 2, 3])))
    np.testing.assert_array_equal(default.numpy(), explicit.numpy())
    greedy = tdec.greedy_generate(tp, torch.from_numpy(prompt[1:2]), 16,
                                  dtype=torch.float32, device="cpu", **CFG)
    np.testing.assert_array_equal(ref[1], greedy.numpy()[0])


def test_speculative_generate_top_k_one_degenerates_to_greedy(weights):
    """top_k=1 makes the warped distribution a point mass: the sampled
    machinery emits the greedy stream token for token."""
    _, _, tp, _ = weights
    prompt = np.random.RandomState(4).randint(
        0, CFG["vocab_size"], size=(4, 5)).astype(np.int32)
    pinned = spec_pair(weights, prompt, 18, temperatures=[1.3] * 4,
                       seeds=[1, 2, 3, 4], top_k=1)
    greedy = tdec.greedy_generate(tp, torch.from_numpy(prompt), 18,
                                  dtype=torch.float32, device="cpu", **CFG)
    np.testing.assert_array_equal(pinned, greedy.numpy())
