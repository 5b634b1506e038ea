"""The split shared by the paged kernels K1, K1q, K2 and K2q
(``split_plan`` in ``kubegpu_tpu_torch/ops/paged_attention.py``) and the
merge of the splits, on the CPU.

- ``split_plan`` at every head width, q/pool type pair and page size the
  kernels serve: two whole pages a split (more where pages are small),
  K1's ring in the card's shared memory, and an answer that depends on
  the page geometry alone.
- The wrappers' launch arguments, with every operand on the ``meta``
  device (no values at all) and the library replaced by a recorder: the
  launch reads no length on the host, so a captured call replays with
  new lengths.
- ``paged_split_attention_plain`` (the split-and-merge in torch ops)
  against the JAX kernels in interpret mode within the reference's 2e-5
  at fp32, over splits of 1, 2, 3 pages and the whole table, lengths at
  and around a split's edge, full-width and int8 pools; with one split
  it is the plain twin bit for bit, a window's row j is it at lengths +
  j bit for bit, and a slot alone is the same slot in a batch.

The kernels' side of the same plan runs under ``-m cuda`` in
tests/test_torch_cuda_kernels.py."""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.paged_attention import (
    paged_chunk_attention as jax_paged_chunk_attention,
    paged_decode_attention as jax_paged_decode_attention,
)
from kubegpu_tpu_torch.ops import paged_attention as pa
from kubegpu_tpu_torch.ops.paged_attention import (
    MAX_KERNEL_PAGE,
    MIN_SPLIT_PAGES,
    OPTIN_SMEM_BYTES,
    SPLIT_ROWS,
    paged_decode_attention_plain,
    paged_split_attention_plain,
    quantize_pages,
    split_plan,
)
from test_torch_paged_chunk_plan import TYPE_PAIRS, instantiation

# the reference's kernel tolerance (tests/test_paging.py)
F32_TOL = 2e-5
PAGES = [1, 8, 32, 128, 5000, MAX_KERNEL_PAGE]
# the small geometry of the plain-helper cases: 6-page tables of 8 rows
PAGE, N_PAGES, HD, HEADS, POOL = 8, 6, 16, 2, 20


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("dtype, quant", TYPE_PAIRS,
                         ids=["f32", "bf16", "f32-int8", "bf16-int8"])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_split_plan_fits_the_card_at_every_width_and_page(hd, dtype, quant,
                                                          page):
    split, tile, stages, smem = split_plan(page, hd, dtype, quant)
    width, _, groups, itemsize = instantiation(hd, dtype, quant)
    # whole pages: two, or as many as SPLIT_ROWS rows fill
    assert split == max(MIN_SPLIT_PAGES, SPLIT_ROWS // page)
    assert split >= 2 and split * page <= max(SPLIT_ROWS, 2 * page)
    # K1's walk: 32 reduction floats, one row's scores (at least the row
    # sums), rounded up to 16 bytes, and the ring
    scores = max(page, groups * width)
    scores += -scores % 4
    assert smem == 4 * (32 + scores) + stages * tile * width * itemsize
    assert smem <= OPTIN_SMEM_BYTES
    assert tile > 0 and tile % groups == 0
    assert tile <= -(-page // groups) * groups
    assert 2 <= stages <= 4


def test_split_plan_takes_the_page_geometry_and_nothing_else():
    """No lengths, batch, window or table width reach the plan, so a slot
    folds the same splits in any batch and K1 at lengths + j the same as
    row j of a window; the serving geometries split as the sweep chose
    (PERF.md)."""
    assert list(inspect.signature(split_plan).parameters) == [
        "page", "hd", "dtype", "quant"]
    for hd, dtype, quant in ((128, torch.bfloat16, False),
                             (64, torch.bfloat16, True),
                             (40, torch.float32, False)):
        assert split_plan(128, hd, dtype, quant)[0] == 2
        assert split_plan(32, hd, dtype, quant)[0] == 2
        assert split_plan(8, hd, dtype, quant)[0] == 8
        assert split_plan(MAX_KERNEL_PAGE, hd, dtype, quant)[0] == 2


class RecordingLibrary:
    """Stands in for the built library: records each launch's arguments
    and reports success."""

    def __init__(self):
        self.calls = []

    def kg_paged_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("rows", [None, 5], ids=["K1", "K2"])
def test_wrappers_launch_with_no_host_read_of_the_lengths(monkeypatch, rows,
                                                          quant):
    """The K1/K2 launch on ``meta`` tensors, which hold no values (a host
    read of the lengths raises): the plan, the workspace and every
    argument but the pointers are the same for any lengths; the split is
    ``split_plan``'s, the workspace (b, rows, h, n_splits, hd + 2)."""
    lib = RecordingLibrary()
    monkeypatch.setattr(pa._build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))
    empties = []
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        empties.append(tuple(shape[0] if len(shape) == 1 else shape))
        return real_empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    meta = torch.device("meta")
    b, h, hd, page, width = 3, 4, 64, 32, 9
    dtype = torch.bfloat16
    q = torch.empty((b, h, hd) if rows is None else (b, rows, h, hd),
                    dtype=dtype, device=meta)
    pool_dtype = torch.int8 if quant else dtype
    kp = torch.empty((10, h, page, hd), dtype=pool_dtype, device=meta)
    sc = (dict(k_scale=torch.empty((10, h), device=meta),
               v_scale=torch.empty((10, h), device=meta)) if quant else {})
    table = torch.empty((b, width), dtype=torch.int32, device=meta)
    for _ in range(2):
        lengths = torch.empty((b,), dtype=torch.int32, device=meta)
        if rows is None:
            pa._launch_kernel(q, kp, kp, table, lengths, sc.get("k_scale"),
                              sc.get("v_scale"), checked=False)
        else:
            pa._launch_chunk_kernel(q, kp, kp, table, lengths,
                                    sc.get("k_scale"), sc.get("v_scale"),
                                    checked=False)
    first, second = lib.calls
    # everything after the pointers: b, rows, h, hd, page, width, the
    # ring, the split, the scale and the stream
    assert first[11:] == second[11:]
    split = split_plan(page, hd, dtype, quant)[0]
    ring = (pa.chunk_plan(page, hd, dtype, quant)[:3] if rows
            else (1, *split_plan(page, hd, dtype, quant)[1:3]))
    assert first[:2] == (1, int(quant))
    assert first[11:21] == (b, rows or 1, h, hd, page, width, *ring, split)
    n_splits = -(-width // split)
    assert (b, rows or 1, h, n_splits, hd + 2) in empties


def make_split_case(seed, lengths, L=None, quant=False):
    """Random pools (int8 with scales from ``quantize_pages`` if
    ``quant``), shuffled 6-page tables, q (b, h, hd) or (b, L, h, hd)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    q = rng.randn(*((b, HEADS, HD) if L is None else (b, L, HEADS, HD)))
    kp, vp = (rng.randn(POOL, HEADS, PAGE, HD) * 0.5 for _ in range(2))
    table = np.stack([rng.choice(POOL, N_PAGES, replace=False)
                      for _ in range(b)]).astype(np.int32)
    q, kp, vp = (torch.from_numpy(a.astype(np.float32)) for a in (q, kp, vp))
    sc = {}
    if quant:
        (kp, ks), (vp, vs) = quantize_pages(kp), quantize_pages(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32)), sc


def run_jax(fn, args, sc):
    q, kp, vp, table, lengths = (jnp.asarray(t.numpy()) for t in args)
    kw = {k: jnp.asarray(v.numpy()) for k, v in sc.items()}
    return np.asarray(fn(q, kp, vp, table, lengths, **kw))


def edge_lengths(split):
    """0, 1, one short of, at and one past the first split's edge, two
    splits' edges, and the full table (clipped to it)."""
    edge, full = split * PAGE, N_PAGES * PAGE
    return [min(n, full) for n in (0, 1, edge - 1, edge, edge + 1,
                                   2 * edge + 1, full)]


SPLITS = [1, 2, 3, N_PAGES]


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("split", SPLITS)
def test_split_plain_matches_the_jax_decode_kernel(split, quant):
    args, sc = make_split_case(split, edge_lengths(split), quant=quant)
    got = paged_split_attention_plain(*args, **sc, pages_per_split=split)
    want = run_jax(jax_paged_decode_attention, args, sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("split", SPLITS)
def test_split_plain_window_matches_the_jax_chunk_kernel(split, quant):
    """A 5-row window whose rows cross the split edges."""
    L = 5
    lengths = [max(0, min(n, N_PAGES * PAGE - (L - 1)))
               for n in edge_lengths(split)]
    args, sc = make_split_case(10 + split, lengths, L=L, quant=quant)
    got = paged_split_attention_plain(*args, **sc, pages_per_split=split)
    want = run_jax(jax_paged_chunk_attention, args, sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("split", [N_PAGES, N_PAGES + 3])
def test_one_split_is_the_plain_twin_bit_for_bit(split, quant):
    """One split merges with c = exp(0) = 1: the unsplit fold, divided
    once."""
    args, sc = make_split_case(20 + split, edge_lengths(2), quant=quant)
    assert torch.equal(
        paged_split_attention_plain(*args, **sc, pages_per_split=split),
        paged_decode_attention_plain(*args, **sc))


@pytest.mark.parametrize("L", [1, 5, 9])
@pytest.mark.parametrize("split", [1, 2, 3])
def test_window_row_j_is_the_one_row_split_at_lengths_plus_j(split, L):
    lengths = [max(0, min(n, N_PAGES * PAGE - (L - 1)))
               for n in edge_lengths(split)]
    (q, kp, vp, table, ln), sc = make_split_case(30 + L, lengths, L=L,
                                                 quant=split == 2)
    out = paged_split_attention_plain(q, kp, vp, table, ln, **sc,
                                      pages_per_split=split)
    for j in range(L):
        assert torch.equal(out[:, j], paged_split_attention_plain(
            q[:, j].contiguous(), kp, vp, table, ln + j, **sc,
            pages_per_split=split)), j


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("split", [1, 2, 3])
def test_a_slot_alone_is_the_slot_in_its_batch(split, quant):
    (q, kp, vp, table, ln), sc = make_split_case(40 + split,
                                                 edge_lengths(split),
                                                 quant=quant)
    batch = paged_split_attention_plain(q, kp, vp, table, ln, **sc,
                                        pages_per_split=split)
    for i in range(q.shape[0]):
        alone = paged_split_attention_plain(
            q[i:i + 1], kp, vp, table[i:i + 1], ln[i:i + 1], **sc,
            pages_per_split=split)
        assert torch.equal(alone[0], batch[i]), i


def test_split_plain_refuses_an_empty_split():
    args, _ = make_split_case(50, [3])
    with pytest.raises(ValueError, match="at least one page"):
        paged_split_attention_plain(*args, pages_per_split=0)
