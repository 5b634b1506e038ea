"""The port's ResNet (kubegpu_tpu_torch/models/resnet.py) against the JAX
package's (kubegpu_tpu/models/resnet.py) at float32 and small widths:
the same flax weights (JAX's init, perturbed so every BatchNorm scale and
statistic is non-trivial), carried over with ``params_from_numpy`` and
bound with ``bind_params``/``bind_buffers``, and the same images give the
same train-mode logits and new ``batch_stats``, the same eval-mode
logits, loss and gradients; the scan-rolled net keeps JAX's stacked
tree and equals the unrolled one; the image stream is JAX's bit for bit.

Tolerances: logits atol 5e-5; loss 1e-5; each gradient leaf within 1e-4
of its own largest magnitude; ``batch_stats`` within 1e-5 of each
leaf's largest magnitude (two float32 implementations that differ in
summation order).  bf16: see ``BF16_LOGIT_TOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kubegpu_tpu.models.data import (
    synthetic_image_batches as jax_synthetic_image_batches,
)
from kubegpu_tpu.models.resnet import (
    ResNet as JaxResNet,
    ScanResNet as JaxScanResNet,
)
from kubegpu_tpu.models.train import cross_entropy as jax_cross_entropy
from kubegpu_tpu_torch.models.data import synthetic_image_batches
from kubegpu_tpu_torch.models.params import (
    bind_buffers,
    bind_params,
    init_resnet_params,
    params_from_numpy,
)
from kubegpu_tpu_torch.models.resnet import (
    ResNet,
    ResNet50,
    ScanResNet,
    ScanResNet50,
    same_padding,
)
from kubegpu_tpu_torch.models.train import cross_entropy

@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the machine between several test processes), restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = 5e-5
LOSS_TOL = 1e-5
GRAD_SHARE = 1e-4
STATS_SHARE = 1e-5
TINY = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)
SCAN = dict(stage_sizes=(2, 2), num_filters=8, num_classes=10)
# bf16 compute over the same f32 weights: both round every conv, the
# stem's cast and each BatchNorm's output to bf16, but in other places
# (XLA fuses the normalization, torch runs it op by op) and the CPU
# convs accumulate differently.  Over the bf16 cases below the logits
# (rms 0.55-1.5) measured 0.0070 and 0.061 apart, as far as either
# package's bf16 logits lie from its own f32 ones (0.0041-0.058); the
# bound is 2.5x the widest gap.  The cast placement itself (the stem's
# input, the head's input) is held exactly, through hooks.
BF16_LOGIT_TOL = 0.15


def images_np(size, batch=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def labels_np(batch=4, seed=1, classes=10):
    return np.random.default_rng(seed).integers(
        0, classes, size=(batch,)).astype(np.int32)


def perturbed_variables(jmodel, size, seed=1):
    """JAX's init, every leaf moved by noise: BatchNorm scales (bn3's
    start at 0) and statistics become non-trivial."""
    x = jnp.asarray(images_np(size, batch=1))
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1 * np.abs(
        rng.standard_normal(a.shape)).astype(np.float32), v["batch_stats"])
    return params, stats


def port_model(cls, cfg, params, stats, dtype=torch.float32):
    model = cls(**cfg, dtype=dtype)
    tp, ts = params_from_numpy(params), params_from_numpy(stats)
    bind_params(model, tp, trainable=True)
    bind_buffers(model, ts)
    return model, tp, ts


def flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, path)
        else:
            yield path, v


def assert_tree_share(got, want, share, what):
    """Every leaf of ``got`` within ``share`` of ``want``'s largest
    magnitude (leaf by leaf)."""
    want = dict(flat(want))
    got = dict(flat(got))
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    for path, w in want.items():
        g = np.asarray(got[path].detach() if torch.is_tensor(got[path])
                       else got[path])
        w = np.asarray(w)
        assert g.shape == w.shape, (what, path)
        bound = share * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, (what, path, err, bound)


CASES = [
    pytest.param(JaxResNet, ResNet, TINY, 32, id="unrolled-32px"),
    # 9, 5 and 3 wide stages: XLA's SAME split of the stride-2 3x3 is
    # (1, 1) there, (0, 1) at 32 px
    pytest.param(JaxResNet, ResNet, TINY, 36, id="unrolled-36px"),
    pytest.param(JaxScanResNet, ScanResNet, SCAN, 32, id="scan-32px"),
]


@pytest.mark.parametrize("jcls, cls, cfg, size", CASES)
def test_train_and_eval_forward_match_jax(jcls, cls, cfg, size):
    jmodel = jcls(**cfg, dtype=jnp.float32)
    params, stats = perturbed_variables(jmodel, size)
    x = images_np(size)

    @jax.jit
    def fwd(params, stats, x):
        logits, new = jmodel.apply({"params": params, "batch_stats": stats},
                                   x, train=True, mutable=["batch_stats"])
        ev = jmodel.apply({"params": params, "batch_stats": stats}, x,
                          train=False)
        return logits, new["batch_stats"], ev

    want, want_stats, want_eval = fwd(params, stats, x)
    model, _, ts = port_model(cls, cfg, params, stats)
    with torch.no_grad():
        ev = model(torch.from_numpy(x), train=False)
        assert_tree_share(ts, stats, 0.0, "eval leaves the stats")
        logits = model(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_eval),
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    # the training forward moved the bound statistics in place
    assert_tree_share(ts, jax.tree.map(np.asarray, want_stats), STATS_SHARE,
                      "batch_stats")


@pytest.mark.parametrize("jcls, cls, cfg, size", CASES)
def test_loss_and_every_gradient_match_jax(jcls, cls, cfg, size):
    jmodel = jcls(**cfg, dtype=jnp.float32)
    params, stats = perturbed_variables(jmodel, size)
    x, y = images_np(size), labels_np()

    @jax.jit
    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
        return jax_cross_entropy(logits, y)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model, tp, _ = port_model(cls, cfg, params, stats)
    loss = cross_entropy(model(torch.from_numpy(x), train=True),
                         torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert_tree_share({n.replace(".", "/"): g for n, g in grads.items()},
                      dict(flat(jax.tree.map(np.asarray, want_grads))),
                      GRAD_SHARE, "gradients")


def test_scan_tree_is_jaxs_and_its_forward_is_the_unrolled_nets():
    """The scan-rolled net's parameters and statistics have JAX's paths
    and shapes (each ``stage{i}_body`` leaf stacked on a leading axis of
    ``block_count - 1``), and unstacked into the unrolled net's blocks
    they give the unrolled net's logits: the relation
    tests/test_models.py holds between JAX's two layouts."""
    jmodel = JaxScanResNet(**SCAN, dtype=jnp.float32)
    params, stats = perturbed_variables(jmodel, 32)
    model = ScanResNet(**SCAN, dtype=torch.float32)
    want = {p: np.shape(a) for p, a in flat(params)}
    got = {n.replace(".", "/"): tuple(t.shape)
           for n, t in model.named_parameters()}
    assert got == want
    want = {p: np.shape(a) for p, a in flat(stats)}
    got = {n.replace(".", "/"): tuple(t.shape)
           for n, t in model.named_buffers()}
    assert got == want
    assert got["stage1_body/block/bn1/mean"] == (1, 8)

    def unstack(tree):
        out = {}
        for name, sub in tree.items():
            stage, _, part = name.partition("_")
            if part == "head":
                out[f"{stage}_block1"] = sub
            elif part == "body":
                n = np.shape(next(iter(flat(sub)))[1])[0]
                for i in range(n):
                    out[f"{stage}_block{i + 2}"] = jax.tree.map(
                        lambda a, i=i: a[i], sub["block"])
            else:
                out[name] = sub
        return out

    x = torch.from_numpy(images_np(32))
    scan, _, scan_stats = port_model(ScanResNet, SCAN, params, stats)
    plain, _, plain_stats = port_model(ResNet, SCAN, unstack(params),
                                       unstack(stats))
    with torch.no_grad():
        for train in (False, True):
            torch.testing.assert_close(scan(x, train=train),
                                       plain(x, train=train),
                                       rtol=1e-6, atol=1e-6)
    assert_tree_share(unstack({k: v for k, v in scan_stats.items()}),
                      plain_stats, 1e-6, "stacked statistics")


@pytest.mark.parametrize("jcls, cls, cfg, size", CASES[::2])
def test_bf16_forward_is_close_to_jaxs_bf16_forward(jcls, cls, cfg, size):
    """The bf16 net against JAX's bf16 net, and the casts where JAX puts
    them: the stem casts the f32 image to bf16 before its conv, every
    conv and BatchNorm runs on bf16, the head's spatial mean is rounded
    to bf16 and its Dense layer runs in f32 on it."""
    jmodel = jcls(**cfg)   # bf16, the JAX default
    params, stats = perturbed_variables(jmodel, size)
    x = images_np(size)
    want = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"])[0])(params, stats, x)
    assert want.dtype == jnp.float32
    model, _, _ = port_model(cls, cfg, params, stats, dtype=torch.bfloat16)
    seen = {}

    def record(name):
        def hook(module, args):
            seen.setdefault(name, set()).add(args[0].dtype)
            if name == "head":
                seen["head_input"] = args[0]
        return hook

    for name, module in model.named_modules():
        if name and type(module).__name__ in ("Conv", "BatchNorm", "Dense"):
            module.register_forward_pre_hook(
                record("head" if name == "head" else "body"))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
        assert seen["body"] == {torch.bfloat16}
        assert seen["head"] == {torch.bfloat16}
        h = seen["head_input"]
        torch.testing.assert_close(
            got, h.float() @ model.head.kernel + model.head.bias,
            rtol=0, atol=0)
    assert got.dtype == torch.float32   # the head runs in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_LOGIT_TOL)


def test_same_padding_is_xlas_split():
    # the stride-2 3x3 of an even size pads the odd pixel after
    assert same_padding((8, 8), 3, 2) == ((0, 1), (0, 1))
    assert same_padding((9, 5), 3, 2) == ((1, 1), (1, 1))
    assert same_padding((8, 9), 1, 2) == ((0, 0), (0, 0))
    assert same_padding((7, 7), 3, 1) == ((1, 1), (1, 1))
    assert same_padding((224, 224), 7, 2) == ((2, 3), (2, 3))


def test_synthetic_image_batches_are_jaxs_bit_for_bit():
    for worker in (0, 3):
        ours = synthetic_image_batches(3, size=8, num_classes=10,
                                       worker_id=worker)
        theirs = jax_synthetic_image_batches(3, size=8, num_classes=10,
                                             worker_id=worker)
        for _ in range(2):
            (a, b), (c, d) = next(ours), next(theirs)
            assert a.dtype == np.float32 and b.dtype == np.int32
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("jcls, cls", [(JaxResNet, ResNet),
                                       (JaxScanResNet, ScanResNet)],
                         ids=["unrolled", "scan"])
def test_fresh_weights_have_jaxs_tree_and_initializers(jcls, cls):
    cfg = dict(stage_sizes=(1, 3), num_filters=16, num_classes=10)
    v = jax.eval_shape(jcls(**cfg).init, jax.random.PRNGKey(0),
                       jnp.ones((1, 32, 32, 3)))
    model = cls(**cfg)
    params, stats = init_resnet_params(
        model, torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(a.shape) for p, a in flat(params)} == {
        p: a.shape for p, a in flat(v["params"])}
    assert {p: tuple(a.shape) for p, a in flat(stats)} == {
        p: a.shape for p, a in flat(v["batch_stats"])}
    for path, t in flat(params):
        assert t.dtype == torch.float32, path
        leaf = path.rpartition("/")[2]
        if leaf == "kernel":
            fan_in = (int(np.prod(t.shape[-4:-1])) if t.ndim >= 4
                      else t.shape[0])
            std = 1 / np.sqrt(fan_in)
            assert float(t.abs().max()) <= 2 * std / 0.8796 + 1e-6, path
            if t.numel() > 2000:
                assert abs(float(t.std()) / std - 1) < 0.1, path
        elif leaf == "scale":
            assert torch.all(t == (0 if "bn3" in path else 1)), path
        else:
            assert torch.all(t == 0), path
    for path, t in flat(stats):
        assert torch.all(t == (1 if path.endswith("var") else 0)), path


@pytest.mark.parametrize("cls", [ResNet50, ScanResNet50],
                         ids=["unrolled", "scan"])
def test_flop_count_is_the_convs_and_the_head(cls):
    """Torch's flop counter over one forward of ResNet-50 at 224 px (how
    the card's smoke counts a step's FLOPs) sees only the convolutions
    and the head's product, 4.1 GMACs an image, in either layout."""
    model = cls(dtype=torch.float32)
    params, stats = init_resnet_params(
        model, torch.Generator().manual_seed(0), "cpu")
    bind_params(model, params)
    bind_buffers(model, stats)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.from_numpy(images_np(224, batch=1)), train=False)
    assert {str(op).split(".")[1] for op in
            counter.get_flop_counts()["Global"]} <= {"convolution", "mm",
                                                     "addmm"}
    assert 2 * 4.08e9 < counter.get_total_flops() < 2 * 4.12e9
