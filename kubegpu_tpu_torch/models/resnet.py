"""ResNet v1.5 in PyTorch: the port of ``kubegpu_tpu/models/resnet.py``
(``BottleneckBlock``, the stem and head of ``_ResNetBase``, ``ResNet``,
``ScanResNet`` and the ``ResNet50`` family of aliases).

The parameter tree is flax's, leaf for leaf: ``conv_init``, ``bn_init``,
``stage{i}_block{j}`` (unrolled) or ``stage{i}_head`` and
``stage{i}_body/block`` (scan-rolled), ``head``; conv kernels HWIO
``(kh, kw, in, out)``, BatchNorm ``scale``/``bias``, the head's
``kernel`` ``(in, out)`` and ``bias``; and the ``batch_stats`` tree of
each BatchNorm's ``mean`` and ``var``.  The scan-rolled variant stacks
every ``stage{i}_body`` leaf on a leading axis of ``block_count - 1``
(flax's ``nn.scan``), and its body loop indexes it.  So a JAX tree, a
checkpoint of either package and a fresh one (``params.init_resnet_params``)
bind the same way: :func:`params.bind_params` for the parameters,
:func:`params.bind_buffers` for the statistics, no copy.

Compute follows the JAX module's dtypes: the f32 image is cast to the
compute dtype (bf16 by default) at the stem; each conv casts its f32
kernel to the compute dtype once a call, laid out ``(out, in, kh, kw)``
in ``channels_last`` (the NHWC input, permuted, already is
``channels_last``, so activations stay NHWC in memory and cuDNN takes
its NHWC kernels); BatchNorm computes in f32
(:func:`parallel.collectives.global_batch_norm`) and returns the compute
dtype; the head's spatial mean is taken in f32 and rounded to the
compute dtype, and its Dense layer runs in f32.

Padding is flax's: ``"SAME"`` everywhere except the stem's explicit
``(3, 3)``.  XLA splits SAME padding ``t = max((ceil(n / s) - 1) s + k -
n, 0)`` as ``lo = t // 2``, ``hi = t - lo``, so the stride-2 3x3 conv of
an even size pads ``(0, 1)``, not torch's symmetric ``(1, 1)``; it is
computed from each input's size (:func:`same_padding`).  The max pool
pads with -inf, as ``nn.max_pool`` does.

In training mode (``train=True``) BatchNorm normalizes with the batch's
statistics, over the global batch when the model has a ``"data"`` mesh,
and updates its running statistics in place as flax does:
``0.9 old + 0.1 batch``, with the biased variance.  So after a training
forward the bound ``batch_stats`` tree holds the new statistics (the
JAX ``mutable=["batch_stats"]`` result).  ``train=False`` normalizes
with the running statistics and changes nothing.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubegpu_tpu_torch.models.params import meta_param
from kubegpu_tpu_torch.parallel.collectives import global_batch_norm

MOMENTUM = 0.9
EPSILON = 1e-5

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def same_padding(size: Tuple[int, int], k: int, stride: int) -> Pad:
    """XLA's SAME padding of a ``k x k`` window at ``stride`` over
    ``size`` (h, w): ``((lo, hi), (lo, hi))``, the odd pixel after."""
    pads = []
    for n in size:
        t = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads.append((t // 2, t - t // 2))
    return tuple(pads)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (stride, stride), use_bias=False)``
    with an HWIO ``kernel`` (a leading axis of ``stack`` when scanned);
    ``padding`` None is SAME, else explicit ``((lo, hi), (lo, hi))``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[Pad] = None, stack: int = 0) -> None:
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.kernel = meta_param(*((stack,) if stack else ()), k, k, cin,
                                 cout)

    def pads(self, size: Tuple[int, int]) -> Pad:
        return self.padding or same_padding(size, self.k, self.stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                i: Optional[int] = None) -> torch.Tensor:
        kernel = self.kernel if i is None else self.kernel[i]
        # one copy a call: the compute dtype, (out, in, kh, kw) laid out
        # channels_last
        w = kernel.permute(3, 2, 0, 1).to(dtype=dtype,
                                           memory_format=torch.channels_last)
        (top, bottom), (left, right) = self.pads(tuple(x.shape[2:]))
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of an NCHW activation: parameters ``scale``, ``bias``, statistics
    ``mean``, ``var`` (buffers), each with a leading axis of ``stack``
    when scanned.  ``zero_scale`` marks the block's last BatchNorm, whose
    scale starts at zero (``init_resnet_params`` reads it)."""

    def __init__(self, c: int, stack: int = 0, zero_scale: bool = False,
                 mesh=None) -> None:
        super().__init__()
        shape = ((stack,) if stack else ()) + (c,)
        self.scale = meta_param(*shape)
        self.bias = meta_param(*shape)
        self.register_buffer("mean", torch.empty(shape, device="meta"))
        self.register_buffer("var", torch.empty(shape, device="meta"))
        self.zero_scale = zero_scale
        self.mesh = mesh

    def forward(self, x: torch.Tensor, train: bool,
                i: Optional[int] = None) -> torch.Tensor:
        pick = (lambda t: t) if i is None else (lambda t: t[i])
        scale, bias = pick(self.scale), pick(self.bias)
        mean, var = pick(self.mean), pick(self.var)
        if train:
            y, batch_mean, batch_var = global_batch_norm(
                x, scale, bias, EPSILON, self.mesh)
            with torch.no_grad():
                mean.copy_(MOMENTUM * mean + (1 - MOMENTUM) * batch_mean)
                var.copy_(MOMENTUM * var + (1 - MOMENTUM) * batch_var)
            return y
        mul = torch.rsqrt(var + EPSILON) * scale
        y = (x.float() - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (y + bias.view(1, -1, 1, 1)).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` with ``kernel`` ``(in, out)`` and ``bias``, run
    in float32."""

    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = meta_param(cin, cout)
        self.bias = meta_param(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (``stride``) -> 1x1 bottleneck of ``filters`` (out
    ``4 filters``), with a projection shortcut (``conv_proj``,
    ``bn_proj``) where the shape changes.  ``stack`` > 0 holds that many
    identity-shaped blocks' parameters stacked (a scanned body); block
    ``i`` of them runs with ``i``."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 stack: int = 0, mesh=None) -> None:
        super().__init__()
        bn = partial(BatchNorm, stack=stack, mesh=mesh)
        self.conv1 = Conv(cin, filters, 1, stack=stack)
        self.bn1 = bn(filters)
        self.conv2 = Conv(filters, filters, 3, stride, stack=stack)
        self.bn2 = bn(filters)
        self.conv3 = Conv(filters, 4 * filters, 1, stack=stack)
        # zero-init the last BN scale: residual branches start as identity
        self.bn3 = bn(4 * filters, zero_scale=True)
        self.project = cin != 4 * filters or stride != 1
        if self.project:
            self.conv_proj = Conv(cin, 4 * filters, 1, stride, stack=stack)
            self.bn_proj = bn(4 * filters)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype,
                i: Optional[int] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, dtype, i), train, i))
        y = F.relu(self.bn2(self.conv2(y, dtype, i), train, i))
        y = self.bn3(self.conv3(y, dtype, i), train, i)
        residual = x
        if self.project:
            residual = self.bn_proj(self.conv_proj(x, dtype, i), train, i)
        return F.relu(residual + y)


class ScanBody(nn.Module):
    """The identity-shaped tail of a stage, ``length`` blocks whose
    parameters are stacked in ``block`` (flax's ``nn.scan`` of
    ``_ScanBody``), run in order."""

    def __init__(self, filters: int, length: int, mesh=None) -> None:
        super().__init__()
        self.length = length
        self.block = BottleneckBlock(4 * filters, filters, stack=length,
                                     mesh=mesh)

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        for i in range(self.length):
            x = self.block(x, train, dtype, i)
        return x


class _ResNetBase(nn.Module):
    """Shared stem and head; subclasses lay out the stage bodies.
    ``mesh`` (a ``"data"`` axis) makes every BatchNorm's statistics the
    global batch's.  ``image_size`` is only recorded (checkpoints
    note it); the network takes any size."""

    layout = ""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 mesh=None, image_size: Optional[int] = None) -> None:
        super().__init__()
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.num_classes, self.num_filters = num_classes, num_filters
        self.dtype, self.mesh, self.image_size = dtype, mesh, image_size
        self.conv_init = Conv(3, num_filters, 7, 2, padding=((3, 3), (3, 3)))
        self.bn_init = BatchNorm(num_filters, mesh=mesh)
        self.stages = []   # the stage modules' names, in order
        self._build(mesh)
        self.head = Dense(4 * num_filters * 2 ** (len(stage_sizes) - 1),
                          num_classes)

    def _add(self, name: str, module: nn.Module) -> None:
        setattr(self, name, module)
        self.stages.append(name)

    def _build(self, mesh) -> None:
        raise NotImplementedError

    def forward(self, images: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """Logits ``(b, num_classes)`` in f32 of NHWC f32 ``images``."""
        # NHWC -> an NCHW view that is channels_last in memory
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x, self.dtype), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.stages:
            x = getattr(self, name)(x, train, self.dtype)
        # flax: the mean of the compute-dtype activations, accumulated in
        # f32, then the f32 Dense
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x)

    def dims(self) -> Dict[str, object]:
        """What a checkpoint records of the model."""
        return dict(family="resnet", layout=self.layout,
                    stage_sizes=list(self.stage_sizes),
                    num_filters=self.num_filters,
                    num_classes=self.num_classes,
                    image_size=self.image_size)


class ResNet(_ResNetBase):
    """ResNet v1.5 (stride 2 on the 3x3), every block its own module
    ``stage{i}_block{j}``."""

    layout = "unrolled"

    def _build(self, mesh) -> None:
        cin = self.num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = self.num_filters * 2 ** i
                self._add(f"stage{i + 1}_block{j + 1}",
                          BottleneckBlock(cin, filters, stride, mesh=mesh))
                cin = 4 * filters


class ScanResNet(_ResNetBase):
    """The same network with each stage's identity-shaped tail blocks
    stacked in one ``stage{i}_body`` (flax's ``nn.scan``), after the
    stage's ``stage{i}_head`` block."""

    layout = "scan"

    def _build(self, mesh) -> None:
        cin = self.num_filters
        for i, count in enumerate(self.stage_sizes):
            filters = self.num_filters * 2 ** i
            self._add(f"stage{i + 1}_head",
                      BottleneckBlock(cin, filters, 2 if i > 0 else 1,
                                      mesh=mesh))
            if count > 1:
                self._add(f"stage{i + 1}_body",
                          ScanBody(filters, count - 1, mesh=mesh))
            cin = 4 * filters


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2))
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3))
ScanResNet50 = partial(ScanResNet, stage_sizes=(3, 4, 6, 3))
ScanResNet101 = partial(ScanResNet, stage_sizes=(3, 4, 23, 3))
ScanResNet152 = partial(ScanResNet, stage_sizes=(3, 8, 36, 3))
