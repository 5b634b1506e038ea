"""The launch plan of the paged verify kernels K2 and K2q
(``chunk_plan`` in ``kubegpu_tpu_torch/ops/paged_attention.py``): the
rows a walk folds, the ring's tile rows and stages, and the shared
memory they take, for every head width, q/pool type pair and page size
the kernels serve.  Pure host arithmetic, so it runs on the CPU; the
kernel side of the same plan runs under ``-m cuda`` in
tests/test_torch_cuda_kernels.py."""

import pytest
import torch

from kubegpu_tpu_torch.ops.paged_attention import (
    MAX_KERNEL_PAGE,
    OPTIN_SMEM_BYTES,
    check_chunk_args,
    chunk_plan,
)

PAGES = [1, 32, 128, 5000, 20000, MAX_KERNEL_PAGE]
# (q dtype, int8 pool)
TYPE_PAIRS = [(torch.float32, False), (torch.bfloat16, False),
              (torch.float32, True), (torch.bfloat16, True)]


def instantiation(hd, dtype, quant):
    """The CUDA instantiation's geometry, from its definition: exact at
    head widths 64 and 128, padded to 32 or 128 otherwise; 16 bytes a
    lane (8 for a padded int8 row); 128 threads.  Returns (HD, columns a
    lane, rows in flight, pool bytes a value)."""
    itemsize = 1 if quant else torch.empty((), dtype=dtype).element_size()
    padded = hd not in (64, 128)
    width = (32 if hd <= 32 else 128) if padded else hd
    vec = 8 if quant and padded else 16 // itemsize
    return width, vec, 128 // (width // vec), itemsize


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("dtype, quant", TYPE_PAIRS,
                         ids=["f32", "bf16", "f32-int8", "bf16-int8"])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_plan_fits_the_card_at_every_width_and_page(hd, dtype, quant, page):
    rows, tile, stages, smem = chunk_plan(page, hd, dtype, quant)
    width, vec, groups, itemsize = instantiation(hd, dtype, quant)
    # 32 reduction floats, the walk's scores (at least the row sums of
    # write_part) rounded up to 16 bytes, and the ring
    scores = max(rows * page, groups * width)
    scores += -scores % 4
    assert smem == 4 * (32 + scores) + stages * tile * width * itemsize
    assert smem <= OPTIN_SMEM_BYTES
    assert 1 <= rows <= 8
    assert tile > 0 and tile % groups == 0
    assert 2 <= stages <= 4
    # the full-width int8 instantiations (16 columns a lane) take at most
    # 4 rows a walk; every other one takes 8 wherever the page allows
    cap = 4 if vec == 16 else 8
    assert rows <= cap
    if page <= 128:
        assert rows == cap
    # a tile never spans more than the page's rows in flight
    assert tile <= -(-page // groups) * groups


def test_plan_folds_fewer_rows_only_for_pages_in_the_thousands():
    """8 rows a walk at the serving paths' pages (128 and 32), and fewer
    only once a page's scores for 8 rows crowd out the ring: 2 rows at
    20,000-row pages, 1 at MAX_KERNEL_PAGE."""
    for page in (32, 128, 5000):
        assert chunk_plan(page, 128, torch.bfloat16, False)[0] == 8
    assert chunk_plan(20000, 128, torch.float32, False)[0] == 2
    assert chunk_plan(MAX_KERNEL_PAGE, 128, torch.float32, False)[0] == 1


def test_plan_and_wrapper_refuse_a_page_past_the_limit():
    """A page above MAX_KERNEL_PAGE has no plan, and the wrapper's checks
    refuse it before a launch, as before the ring."""
    with pytest.raises(ValueError, match="page size"):
        chunk_plan(MAX_KERNEL_PAGE + 1, 128, torch.float32, False)
    q = torch.zeros((1, 2, 1, 8))
    table = torch.zeros((1, 1), dtype=torch.int32)
    lengths = torch.ones((1,), dtype=torch.int32)
    pool = torch.zeros((1, 1, MAX_KERNEL_PAGE + 1, 8))
    with pytest.raises(ValueError, match="opt-in shared memory"):
        check_chunk_args(q, pool, pool, table, lengths)
