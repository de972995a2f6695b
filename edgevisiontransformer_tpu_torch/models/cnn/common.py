"""Shared CNN building blocks (port of ``edgevisiontransformer_tpu/models/cnn/common.py``).

Conv-BN-act, SE, the inverted residual, the shuffle, SqueezeNet's fire
module and ResNet's bottleneck, as ``nn.Module``s on NCHW tensors with
``F.conv2d`` (cuDNN on the card: the JAX zoo runs XLA convolutions, no
Pallas kernel).  Inference only: every BatchNorm normalizes with its
running statistics (the buffers ``mean`` and ``var``).

Each module names its children as Flax names a compact module's
submodules (``Conv_0``, ``BatchNorm_0``, ``ConvBNAct_2``: the class name and
its count among the parent's children of that class, in creation order),
and the leaves keep Flax's names (``kernel``, ``bias``, ``scale``,
``mean``, ``var``), so ``named_parameters()`` / ``named_buffers()`` are the
Flax ``params`` / ``batch_stats`` trees.  Kernels keep PyTorch's layouts:
a conv's ``[out, in / groups, kh, kw]``, a Dense's ``[out, in]``
(``utils/jax_bridge.load_flax_cnn`` transposes the Flax ones).

Where the two frameworks differ the port follows Flax: ``"SAME"`` padding
is TF's rule (at stride 2 the extra row and column go at the bottom and
right), so it is computed from the input size and padded explicitly where
it is not symmetric; a SAME max pool pads with -inf, a SAME average pool
counts the padded zeros; the BatchNorm epsilon is each block's (1e-3 in
``ConvBNAct`` and the inception blocks, Flax's default 1e-5 in the
pre-activation bottleneck).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """What the registry reads of a CNN: the input size the zoo is timed
    at (any size its strides allow is accepted), its channels and classes."""

    image_size: int = 224
    in_channels: int = 3
    num_classes: int = 1000


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "hswish": hard_swish,
    "swish": F.silu,
    "linear": lambda x: x,
}


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax / TF ``"SAME"``: ``ceil(size / stride)`` outputs, the padding
    split with the odd row or column after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Tuple[int, int], stride: int, padding) -> list:
    """``[(lo_h, hi_h), (lo_w, hi_w)]`` for ``"SAME"``, ``"VALID"`` or
    explicit pairs."""
    if padding == "SAME":
        return [same_pads(x.shape[2 + d], kernel[d], stride) for d in range(2)]
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    return [tuple(p) for p in padding]


def max_pool(x: torch.Tensor, window: int, stride: int, padding: str = "VALID") -> torch.Tensor:
    """``nn.max_pool`` (``VALID`` by default; ``SAME`` pads with -inf)."""
    (th, bh), (lw, rw) = _pads(x, (window, window), stride, padding)
    if th or bh or lw or rw:
        x = F.pad(x, (lw, rw, th, bh), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: str = "VALID") -> torch.Tensor:
    """``nn.avg_pool``: the padded zeros count in the mean."""
    (th, bh), (lw, rw) = _pads(x, (window, window), stride, padding)
    if th or bh or lw or rw:
        x = F.pad(x, (lw, rw, th, bh))
    return F.avg_pool2d(x, window, stride)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The JAX function's channel order (it shuffles the last, NHWC axis):
    channel ``i1 * (c / g) + i2`` moves to ``i2 * g + i1``."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _lecun_normal_(prm: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> None:
    """Flax's default kernel init: truncated normal of variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(prm, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class FlaxNamed(nn.Module):
    """A module whose children take Flax's automatic names (:meth:`sub`)."""

    def __init__(self):
        super().__init__()
        self._counts: dict = {}

    def sub(self, module: nn.Module) -> nn.Module:
        name = type(module).__name__
        count = self._counts.get(name, 0)
        self._counts[name] = count + 1
        self.add_module(f"{name}_{count}", module)
        return module

    def __setattr__(self, name: str, value) -> None:
        # an attribute naming a child already registered under its Flax name
        # is a plain alias, not a second registration
        if isinstance(value, nn.Module) and any(value is m for m in self._modules.values()):
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: kernel ``[out, in / groups, kh, kw]``,
    ``"SAME"`` (default), ``"VALID"`` or explicit padding."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, int],
                 strides: int = 1, padding: str | Sequence = "SAME", groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.strides, self.padding, self.groups = kernel, strides, padding, groups
        self.kernel = nn.Parameter(torch.empty(features, cin // groups, *kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        _lecun_normal_(self.kernel, self.kernel[0].numel(), gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (th, bh), (lw, rw) = _pads(x, self.kernel_size, self.strides, self.padding)
        if th == bh and lw == rw:
            return F.conv2d(x, self.kernel, self.bias, self.strides, (th, lw), 1, self.groups)
        return F.conv2d(F.pad(x, (lw, rw, th, bh)), self.kernel, self.bias, self.strides, 0, 1,
                        self.groups)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(use_running_average=True)`` over channels."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0,
                            self.epsilon)


class Dense(nn.Module):
    """``flax.linen.Dense``: kernel ``[out, in]``, bias."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, cin))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        _lecun_normal_(self.kernel, self.kernel.shape[1], gen)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


class ConvBN:
    """A conv (no bias) + BatchNorm + optional ReLU made in the caller's
    scope, as the JAX inception code's ``conv7`` / ``_conv_bn`` helpers do:
    the two modules are the caller's ``Conv_i`` and ``BatchNorm_i``."""

    def __init__(self, parent: FlaxNamed, cin: int, feats: int, kh: int, kw: int,
                 stride: int = 1, padding: str = "SAME", act: bool = True):
        self.conv = parent.sub(Conv(cin, feats, (kh, kw), stride, padding, use_bias=False))
        self.bn = parent.sub(BatchNorm(feats, epsilon=1e-3))
        self.act = act

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class ConvBNAct(FlaxNamed):
    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: str = "relu", use_bn: bool = True,
                 padding: str | Sequence = "SAME"):
        super().__init__()
        self.act = act
        self.conv = self.sub(Conv(cin, features, (kernel, kernel), stride, padding, groups,
                                  use_bias=not use_bn))
        self.bn = self.sub(BatchNorm(features, epsilon=1e-3)) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return ACTS[self.act](x)


class DepthwiseConvBNAct(FlaxNamed):
    def __init__(self, c: int, kernel: int = 3, stride: int = 1, act: str = "relu"):
        super().__init__()
        self.block = self.sub(ConvBNAct(c, c, kernel, stride, groups=c, act=act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class SEBlock(FlaxNamed):
    def __init__(self, c: int, reduction: int = 4, gate: str = "hsigmoid"):
        super().__init__()
        mid = max(c // reduction, 8)
        self.gate = gate
        self.squeeze = self.sub(Conv(c, mid, (1, 1)))
        self.excite = self.sub(Conv(mid, c, (1, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.excite(F.relu(self.squeeze(s)))
        s = hard_sigmoid(s) if self.gate == "hsigmoid" else torch.sigmoid(s)
        return x * s


class InvertedResidual(FlaxNamed):
    """MobileNetV2/V3 / MNASNet / Proxyless MBConv block."""

    def __init__(self, cin: int, features: int, expand: float = 6.0, kernel: int = 3,
                 stride: int = 1, act: str = "relu6", se: bool = False, se_reduction: int = 4):
        super().__init__()
        hidden = int(round(cin * expand))
        self.expand_conv = (self.sub(ConvBNAct(cin, hidden, 1, act=act))
                            if hidden != cin else None)
        self.depthwise = self.sub(ConvBNAct(hidden, hidden, kernel, stride, groups=hidden,
                                            act=act))
        self.se = self.sub(SEBlock(hidden, se_reduction)) if se else None
        self.project = self.sub(ConvBNAct(hidden, features, 1, act="linear"))
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand_conv(x) if self.expand_conv is not None else x
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return h + x if self.residual else h


class FireModule(FlaxNamed):
    """SqueezeNet fire module."""

    def __init__(self, cin: int, squeeze: int, expand1: int, expand3: int):
        super().__init__()
        self.squeeze = self.sub(Conv(cin, squeeze, (1, 1)))
        self.expand1 = self.sub(Conv(squeeze, expand1, (1, 1)))
        self.expand3 = self.sub(Conv(squeeze, expand3, (3, 3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))], dim=1)


class ResNetBottleneck(FlaxNamed):
    """features: the bottleneck width; the output is 4x."""

    def __init__(self, cin: int, features: int, stride: int = 1, preact: bool = False):
        super().__init__()
        out_c = features * 4
        project = cin != out_c or stride != 1
        self.preact = preact
        if preact:  # v2: Flax's default BatchNorm epsilon, convs with bias
            self.bn_in = self.sub(BatchNorm(cin))
            self.shortcut = self.sub(Conv(cin, out_c, (1, 1), stride)) if project else None
            conv1, bn1 = self.sub(Conv(cin, features, (1, 1))), self.sub(BatchNorm(features))
            conv2 = self.sub(Conv(features, features, (3, 3), stride))
            bn2 = self.sub(BatchNorm(features))
            self.convs = [conv1, conv2, self.sub(Conv(features, out_c, (1, 1)))]
            self.bns = [bn1, bn2]
        else:
            self.convs = [self.sub(ConvBNAct(cin, features, 1, act="relu")),
                          self.sub(ConvBNAct(features, features, 3, stride, act="relu")),
                          self.sub(ConvBNAct(features, out_c, 1, act="linear"))]
            self.shortcut = (self.sub(ConvBNAct(cin, out_c, 1, stride, act="linear"))
                             if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.preact:
            x = F.relu(self.bn_in(x))
            if self.shortcut is not None:
                shortcut = self.shortcut(x)
            h = F.relu(self.bns[0](self.convs[0](x)))
            h = F.relu(self.bns[1](self.convs[1](h)))
            return self.convs[2](h) + shortcut
        h = self.convs[2](self.convs[1](self.convs[0](x)))
        if self.shortcut is not None:
            shortcut = self.shortcut(x)
        return F.relu(h + shortcut)


class CNN(FlaxNamed):
    """A zoo model: NCHW input (cast to the parameters' dtype), built on the
    CPU, initialised from ``generator`` as the Flax initialisers do
    (lecun-normal kernels, zero biases, unit BatchNorm scales, zero means
    and unit variances), then moved to ``device``: the card unless the
    caller names another (``models/vit.model_device``); ``"meta"`` builds
    shapes only."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.config = CNNConfig(num_classes=num_classes)

    def _place(self, device, generator: torch.Generator | None) -> None:
        from ..vit import model_device

        dev = model_device(device)
        if dev.type != "meta":
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, (Conv, BatchNorm, Dense)):
                        m.reset_parameters(generator)
        self.eval()
        self.to(dev)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self._forward(img.to(next(self.parameters()).dtype))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _Classifier(FlaxNamed):
    def __init__(self, cin: int, num_classes: int = 1000):
        super().__init__()
        self.dense = self.sub(Dense(cin, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x.mean(dim=(2, 3)))
