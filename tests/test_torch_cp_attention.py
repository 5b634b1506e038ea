"""Context-parallel attention in the port (``ops/attention.py``'s
``ring_attention`` and ``ulysses_attention``, ``parallel/collectives.py``'s
``ring_shift``, ``seq_to_heads``/``heads_to_seq`` and ``gather_axis``)
against the JAX package's ``ring_attention_sharded`` and
``ulysses_attention_sharded`` on a two-device ``"sp"`` mesh of the
virtual CPU devices (``tests/conftest.py``; the Pallas kernels in
interpret mode), at float32.

The port's side runs in one gang of two JAX-free processes over gloo on
the CPU (``parallel.launch.Gang`` on a ``{"data": 1, "seq": 2}`` mesh,
rank bodies in ``tests/torch_cp_cases.py``), started once for the
module.  The inputs are drawn from a numpy seed; each rank takes its
half of the sequence and rank 0 joins the halves back.

- The ring's flash body (a 16-row shard, which ``ring_block_sizes``
  tiles) and its einsum body (136 rows, which it does not), causal and
  not, and Ulysses (4 heads over 2 ranks, flash and the reference
  attention), causal and not: out within 2e-5 and dq, dk, dv within
  1e-4 of JAX's (the flash twins' tolerances).
- ``ring_block_sizes`` is the JAX rule for every shard length, so each
  shape takes the reference's numerics; the dispatch of a ring step
  (unmasked, diagonal, skipped) is the JAX one, which launches K3, K4
  and K5 (r + 1) times on the rank at coordinate r when causal.
- The collectives' forwards and backwards on both ranks, and the bytes
  they count.
- Ulysses refuses a local head count that does not divide by the axis,
  with JAX's error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kubegpu_tpu.ops import ring_attention_sharded, ulysses_attention_sharded
from kubegpu_tpu.ops.attention import _ring_block_sizes
from kubegpu_tpu_torch.ops.attention import (
    _ring_block,
    ring_block_sizes,
    ulysses_attention,
)
from kubegpu_tpu_torch.parallel.launch import Gang
from kubegpu_tpu_torch.parallel.mesh import Mesh
import torch_cp_cases as cases

AXES = {"data": 1, "seq": 2}
OUT_TOL = 2e-5
GRAD_TOL = 1e-4
GANG_TIMEOUT_S = 300.0


def inputs(s_loc, heads=4, seed=0, b=2, d=16):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(b, 2 * s_loc, heads, d).astype(np.float32)
            for n in ("q", "k", "v", "dout")}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    g = Gang(AXES, str(tmp_path_factory.mktemp("cp2")), backend="gloo",
             devices=["cpu"] * 2, timeout_s=GANG_TIMEOUT_S)
    yield g
    g.close()


@pytest.fixture(scope="module")
def sp_mesh():
    return JaxMesh(np.array(jax.devices()[:2]), ("sp",))


def jax_attention(fn, x, mesh):
    """out and (dq, dk, dv) of ``fn`` (a ``*_sharded`` function of the
    global q, k, v) under the cotangent ``x["dout"]``."""
    q, k, v, dout = (jnp.asarray(x[n]) for n in ("q", "k", "v", "dout"))
    out, vjp = jax.vjp(jax.jit(fn), q, k, v)
    dq, dk, dv = vjp(dout)
    return dict(out=np.asarray(out), dq=np.asarray(dq), dk=np.asarray(dk),
                dv=np.asarray(dv))


def assert_matches(got, want):
    np.testing.assert_allclose(got["out"], want["out"], rtol=OUT_TOL,
                               atol=OUT_TOL)
    for n in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[n], want[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_loc, impl", [
    (16, "flash"),      # ring_block_sizes tiles it: the flash body
    (136, "flash"),     # it does not: the einsum body, as in JAX
    (136, "einsum"),
], ids=["flash-body-16", "einsum-body-136", "einsum-136"])
def test_ring_attention_matches_jax_ring_attention_sharded(
        gang, sp_mesh, s_loc, impl, causal):
    x = inputs(s_loc, seed=s_loc)
    got = gang.run(cases.attention, dict(
        x, impl="ring" if impl == "flash" else "ring-einsum",
        causal=causal))
    want = jax_attention(functools.partial(
        ring_attention_sharded, mesh=sp_mesh, axis="sp", causal=causal,
        impl=impl), x, sp_mesh)
    assert_matches(got, want)
    # the CPU runs the kernels' twins: no kernel launched
    assert not any(n for r in got["launches"] for n in r.values())
    # from each rank: the flash body's K and V hop once forward, then K,
    # V and the float32 dK, dV once and dK, dV home backward; the einsum
    # body's K and V hop once forward and their gradients once back
    kv = x["q"][:, :s_loc].nbytes
    want_bytes = (8 if impl == "flash" and s_loc == 16 else 4) * kv
    assert all(t["ring_shift"] == want_bytes and t["all_to_all"] == 0
               and t["host_staged"] == 0 for t in got["traffic"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "reference"])
def test_ulysses_matches_jax_ulysses_attention_sharded(gang, sp_mesh,
                                                       use_flash, causal):
    x = inputs(16, seed=3)
    got = gang.run(cases.attention, dict(
        x, impl="ulysses" if use_flash else "ulysses-reference",
        causal=causal))
    want = jax_attention(functools.partial(
        ulysses_attention_sharded, mesh=sp_mesh, axis="sp", causal=causal,
        use_flash=use_flash), x, sp_mesh)
    assert_matches(got, want)
    # q, k, v and out forward, their gradients backward: half of each
    # rank's (b, s / 2, h, d) leaves it, eight times
    half = x["q"][:, :16].nbytes // 2
    assert all(t["all_to_all"] == 8 * half and t["ring_shift"] == 0
               for t in got["traffic"])


def test_ring_block_sizes_is_the_jax_rule():
    for s_loc in range(1, 4097):
        assert ring_block_sizes(s_loc) == _ring_block_sizes(s_loc), s_loc


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_ring_steps_dispatch_as_jax(size):
    """Causal: the block owned by ``src = (my - step) % size`` runs
    unmasked when ``src < my``, causal on the diagonal and not at all
    when ``src > my``, so rank r launches its kernels r + 1 times a
    layer; not causal, every block runs unmasked."""
    for my in range(size):
        kinds = [_ring_block(my, size, step, True) for step in range(size)]
        assert kinds[0] is True and kinds.count(True) == 1
        assert sum(k is not None for k in kinds) == my + 1
        for step, kind in enumerate(kinds):
            src = (my - step) % size
            assert kind == (None if src > my else src == my)
        assert [_ring_block(my, size, step, False)
                for step in range(size)] == [False] * size


def test_collectives_forward_and_backward(gang):
    every = gang.run(cases.cp_collectives)
    x = [np.arange(2 * 4 * 4 * 3, dtype=np.float64).reshape(2, 4, 4, 3)
         + 1000.0 * r for r in range(2)]
    for r, got in enumerate(every):
        other = 1 - r
        assert got["groups"] == {"seq": [0, 1]}
        # ppermute forward; the gradient (rank-dependent) shifts back
        np.testing.assert_array_equal(got["ring_shift"][0], x[other])
        np.testing.assert_array_equal(got["ring_shift"][1],
                                      np.full_like(x[r], other + 1))
        # rows -> heads: every rank's rows of this rank's two heads
        whole = np.concatenate(x, axis=1)
        np.testing.assert_array_equal(got["seq_to_heads"][0],
                                      whole[:, :, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["round_trip"], x[r])
        # the gradient of seq_to_heads is heads_to_seq of the upstream
        up = [np.concatenate([np.full((2, 4, 2, 3), q + 1.0)
                              for _ in range(2)], axis=1) for q in range(2)]
        np.testing.assert_array_equal(
            got["seq_to_heads"][1],
            np.concatenate([u[:, 4 * r:4 * r + 4] for u in up], axis=2))
        np.testing.assert_array_equal(got["gather_axis"][0], whole)
        # reduce-scatter of every rank's upstream (q + 1 each)
        np.testing.assert_array_equal(got["gather_axis"][1],
                                      np.full_like(x[r], 3.0))
        np.testing.assert_array_equal(got["mesh_mean"][0],
                                      (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(got["mesh_mean"][1],
                                      np.full_like(x[r], r + 1.0))
        # two tensors in one batch, outside autograd
        np.testing.assert_array_equal(got["ring_shift_pair"][0], x[other])
        np.testing.assert_array_equal(got["ring_shift_pair"][1],
                                      2 * x[other])


def test_ulysses_refuses_indivisible_heads_as_jax_does(sp_mesh):
    mesh = Mesh(size=2, rank=0, device=torch.device("cpu"), backend="gloo",
                axis_names=tuple(AXES), axis_sizes=tuple(AXES.values()))
    q = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError) as got:
        ulysses_attention(q, q, q, mesh, True)
    qj = jnp.zeros((1, 8, 3, 8))
    with pytest.raises(ValueError) as want:
        ulysses_attention_sharded(qj, qj, qj, sp_mesh, "sp", True)
    assert str(got.value) == str(want.value).replace("'sp'", "'seq'")
