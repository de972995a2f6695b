"""CNN model zoo (port of ``edgevisiontransformer_tpu/models/cnn/zoo.py``).

The reference benchmarks 15 CNNs against the ViTs (its ``cnn_zoo.py:50-119``:
mobilenet v1/v2/v3, squeezenet, efficientnet(-lite), resnet50(v2),
shufflenet v1/v2, proxyless, mnasnet, inception).  Each model is a
stage-config list over the block kit in ``common.py``, takes NCHW input and
is built on ``device``, the card unless the caller names another; its
parameters and BatchNorm statistics are named as the JAX model's
(``utils/jax_bridge.load_flax_cnn`` copies a Flax tree in exactly).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import (
    ACTS,
    CNN,
    BatchNorm,
    Conv,
    ConvBNAct,
    Dense,
    FireModule,
    FlaxNamed,
    InvertedResidual,
    ResNetBottleneck,
    _Classifier,
    avg_pool,
    channel_shuffle,
    max_pool,
)


class MobileNetV1(CNN):
    def __init__(self, num_classes: int = 1000, width: float = 1.0, *, device="cuda",
                 generator=None):
        super().__init__(num_classes)
        c = lambda ch: max(8, int(ch * width))  # noqa: E731
        cin = c(32)
        self.layers = [self.sub(ConvBNAct(3, cin, 3, 2))]
        # (features, stride) depthwise-separable stack
        for feats, stride in [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                              (512, 2), *[(512, 1)] * 5, (1024, 2), (1024, 1)]:
            self.layers.append(self.sub(ConvBNAct(cin, cin, 3, stride, groups=cin)))  # depthwise
            self.layers.append(self.sub(ConvBNAct(cin, c(feats), 1)))               # pointwise
            cin = c(feats)
        self.classifier = self.sub(_Classifier(cin, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.classifier(x)


_MBV2_CFG = [  # t, c, n, s
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class MobileNetV2(CNN):
    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.layers = [self.sub(ConvBNAct(3, 32, 3, 2, act="relu6"))]
        cin = 32
        for t, ch, n, s in _MBV2_CFG:
            for i in range(n):
                self.layers.append(self.sub(InvertedResidual(cin, ch, t, 3, s if i == 0 else 1,
                                                             "relu6")))
                cin = ch
        self.layers.append(self.sub(ConvBNAct(cin, 1280, 1, act="relu6")))
        self.classifier = self.sub(_Classifier(1280, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.classifier(x)


# k, exp, out, se, act, stride
_MBV3_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2), (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2), (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]
_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2), (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2), (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1), (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1), (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1), (5, 576, 96, True, "hswish", 1),
]


class MobileNetV3(CNN):
    def __init__(self, num_classes: int = 1000, variant: str = "large", *, device="cuda",
                 generator=None):
        super().__init__(num_classes)
        cfg = _MBV3_LARGE if variant == "large" else _MBV3_SMALL
        last = 960 if variant == "large" else 576
        hidden = 1280 if variant == "large" else 1024
        self.layers = [self.sub(ConvBNAct(3, 16, 3, 2, act="hswish"))]
        cin = 16
        for k, exp, out, se, act, s in cfg:
            self.layers.append(self.sub(InvertedResidual(cin, out, exp / cin, k, s, act, se=se)))
            cin = out
        self.layers.append(self.sub(ConvBNAct(cin, last, 1, act="hswish")))
        self.fc1 = self.sub(Dense(last, hidden))
        self.fc2 = self.sub(Dense(hidden, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        x = ACTS["hswish"](self.fc1(x.mean(dim=(2, 3))))
        return self.fc2(x)


class SqueezeNet(CNN):
    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.stem = self.sub(Conv(3, 96, (7, 7), 2))
        self.fires = []
        cin = 96
        for sq, e1, e3 in [(16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
                           (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)]:
            self.fires.append(self.sub(FireModule(cin, sq, e1, e3)))
            cin = e1 + e3
        self.final = self.sub(Conv(cin, num_classes, (1, 1)))
        self._place(device, generator)

    def _forward(self, x):
        x = max_pool(F.relu(self.stem(x)), 3, 2)
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if i in (2, 6):
                x = max_pool(x, 3, 2)
        return F.relu(self.final(x)).mean(dim=(2, 3))


class ResNet50(CNN):
    def __init__(self, num_classes: int = 1000, preact: bool = False, *, device="cuda",
                 generator=None):
        super().__init__(num_classes)
        self.stem = self.sub(ConvBNAct(3, 64, 7, 2))
        self.blocks = []
        cin = 64
        for stage, (blocks, width) in enumerate([(3, 64), (4, 128), (6, 256), (3, 512)]):
            for i in range(blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                self.blocks.append(self.sub(ResNetBottleneck(cin, width, stride, preact=preact)))
                cin = width * 4
        self.final_bn = self.sub(BatchNorm(cin)) if preact else None
        self.classifier = self.sub(_Classifier(cin, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        x = max_pool(self.stem(x), 3, 2, padding="SAME")
        for block in self.blocks:
            x = block(x)
        if self.final_bn is not None:
            x = F.relu(self.final_bn(x))
        return self.classifier(x)


# EfficientNet-B0 MBConv config: (expand, c, n, s, k)
_EFFNET_B0 = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]


class EfficientNet(CNN):
    def __init__(self, num_classes: int = 1000, lite: bool = False, *, device="cuda",
                 generator=None):
        super().__init__(num_classes)
        act = "relu6" if lite else "swish"  # lite: ReLU6, no SE
        self.layers = [self.sub(ConvBNAct(3, 32, 3, 2, act=act))]
        cin = 32
        for t, ch, n, s, k in _EFFNET_B0:
            for i in range(n):
                self.layers.append(self.sub(InvertedResidual(
                    cin, ch, t, k, s if i == 0 else 1, act, se=not lite, se_reduction=4 * t)))
                cin = ch
        self.layers.append(self.sub(ConvBNAct(cin, 1280, 1, act=act)))
        self.classifier = self.sub(_Classifier(1280, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.classifier(x)


class ShuffleUnitV2(FlaxNamed):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        c = features // 2
        if stride == 1:
            self.left, right_in = [], cin // 2
        else:
            self.left = [self.sub(ConvBNAct(cin, cin, 3, 2, groups=cin, act="linear")),
                         self.sub(ConvBNAct(cin, c, 1))]
            right_in = cin
        self.right = [self.sub(ConvBNAct(right_in, c, 1)),
                      self.sub(ConvBNAct(c, c, 3, stride, groups=c, act="linear")),
                      self.sub(ConvBNAct(c, c, 1))]

    def forward(self, x):
        if self.stride == 1:
            left, right = torch.chunk(x, 2, dim=1)
        else:
            left = right = x
        for layer in self.left:
            left = layer(left)
        for layer in self.right:
            right = layer(right)
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


class ShuffleNetV2(CNN):
    def __init__(self, num_classes: int = 1000, channels: Tuple[int, ...] = (116, 232, 464), *,
                 device="cuda", generator=None):  # 1.0x
        super().__init__(num_classes)
        self.stem = self.sub(ConvBNAct(3, 24, 3, 2))
        self.units = []
        cin = 24
        for ch, blocks in zip(channels, (4, 8, 4)):
            self.units.append(self.sub(ShuffleUnitV2(cin, ch, 2)))
            for _ in range(blocks - 1):
                self.units.append(self.sub(ShuffleUnitV2(ch, ch, 1)))
            cin = ch
        self.last = self.sub(ConvBNAct(cin, 1024, 1))
        self.classifier = self.sub(_Classifier(1024, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        x = max_pool(self.stem(x), 3, 2, padding="SAME")
        for unit in self.units:
            x = unit(x)
        return self.classifier(self.last(x))


class ShuffleUnitV1(FlaxNamed):
    def __init__(self, cin: int, features: int, groups: int = 3, stride: int = 1,
                 first: bool = False):
        super().__init__()
        mid = features // 4
        out_c = features - cin if stride == 2 else features
        self.groups, self.stride = groups, stride
        self.reduce = self.sub(ConvBNAct(cin, mid, 1, groups=1 if first else groups))
        self.depthwise = self.sub(ConvBNAct(mid, mid, 3, stride, groups=mid, act="linear"))
        self.expand = self.sub(ConvBNAct(mid, out_c, 1, groups=groups, act="linear"))

    def forward(self, x):
        h = channel_shuffle(self.reduce(x), self.groups)
        h = self.expand(self.depthwise(h))
        if self.stride == 2:
            short = avg_pool(x, 3, 2, padding="SAME")
            return F.relu(torch.cat([short, h], dim=1))
        return F.relu(h + x)


class ShuffleNetV1(CNN):
    def __init__(self, num_classes: int = 1000, groups: int = 3,
                 channels: Tuple[int, ...] = (240, 480, 960), *, device="cuda",
                 generator=None):  # g=3, 1.0x
        super().__init__(num_classes)
        self.stem = self.sub(ConvBNAct(3, 24, 3, 2))
        self.units = []
        cin = 24
        for si, (ch, blocks) in enumerate(zip(channels, (4, 8, 4))):
            self.units.append(self.sub(ShuffleUnitV1(cin, ch, groups, 2, first=si == 0)))
            for _ in range(blocks - 1):
                self.units.append(self.sub(ShuffleUnitV1(ch, ch, groups, 1)))
            cin = ch
        self.classifier = self.sub(_Classifier(cin, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        x = max_pool(self.stem(x), 3, 2, padding="SAME")
        for unit in self.units:
            x = unit(x)
        return self.classifier(x)


# MNASNet-B1: (expand, c, n, s, k, se)
_MNASNET_B1 = [
    (1, 16, 1, 1, 3, False), (3, 24, 3, 2, 3, False), (3, 40, 3, 2, 5, False),
    (6, 80, 3, 2, 5, False), (6, 96, 2, 1, 3, False), (6, 192, 4, 2, 5, False),
    (6, 320, 1, 1, 3, False),
]

# ProxylessNAS-mobile: (expand, c, n, s, k) — mixed NAS-style expansions,
# sized to the published ~4.1M params
_PROXYLESS_MOBILE = [
    (1, 16, 1, 1, 3), (3, 32, 2, 2, 5), (3, 40, 4, 2, 7),
    (6, 80, 2, 2, 7), (3, 80, 2, 1, 5),
    (6, 96, 2, 1, 5), (3, 96, 2, 1, 5),
    (6, 192, 1, 2, 7), (3, 192, 3, 1, 7), (6, 320, 1, 1, 7),
]


class MNASNet(CNN):
    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.layers = [self.sub(ConvBNAct(3, 32, 3, 2)),
                       self.sub(ConvBNAct(32, 32, 3, 1, groups=32)),
                       self.sub(ConvBNAct(32, 16, 1, act="linear"))]
        cin = 16
        for t, ch, n, s, k, se in _MNASNET_B1[1:]:
            for i in range(n):
                self.layers.append(self.sub(InvertedResidual(cin, ch, t, k, s if i == 0 else 1,
                                                             "relu", se=se)))
                cin = ch
        self.layers.append(self.sub(ConvBNAct(cin, 1280, 1)))
        self.classifier = self.sub(_Classifier(1280, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.classifier(x)


class ProxylessNAS(CNN):
    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.layers = [self.sub(ConvBNAct(3, 32, 3, 2, act="relu6"))]
        cin = 32
        for t, ch, n, s, k in _PROXYLESS_MOBILE:
            for i in range(n):
                self.layers.append(self.sub(InvertedResidual(cin, ch, t, k, s if i == 0 else 1,
                                                             "relu6")))
                cin = ch
        self.layers.append(self.sub(ConvBNAct(cin, 1280, 1, act="relu6")))
        self.classifier = self.sub(_Classifier(1280, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.classifier(x)


from .inception import InceptionResNetV2, InceptionV3  # noqa: E402

CNN_ZOO = {
    "inception_v3": lambda **kw: InceptionV3(**kw),
    "inception_resnet_v2": lambda **kw: InceptionResNetV2(**kw),
    "mobilenet_v1": lambda **kw: MobileNetV1(**kw),
    "mobilenet_v2": lambda **kw: MobileNetV2(**kw),
    "mobilenet_v3_large": lambda **kw: MobileNetV3(variant="large", **kw),
    "mobilenet_v3_small": lambda **kw: MobileNetV3(variant="small", **kw),
    "squeezenet": lambda **kw: SqueezeNet(**kw),
    "resnet50": lambda **kw: ResNet50(**kw),
    "resnet50_v2": lambda **kw: ResNet50(preact=True, **kw),
    "efficientnet_b0": lambda **kw: EfficientNet(**kw),
    "efficientnet_lite0": lambda **kw: EfficientNet(lite=True, **kw),
    "shufflenet_v1": lambda **kw: ShuffleNetV1(**kw),
    "shufflenet_v2": lambda **kw: ShuffleNetV2(**kw),
    "mnasnet": lambda **kw: MNASNet(**kw),
    "proxyless_mobile": lambda **kw: ProxylessNAS(**kw),
}


def get_cnn(name: str, **kw) -> CNN:
    """A zoo model by name; ``kw`` goes to its class (``num_classes``,
    ``device``, the card by default, ``generator``)."""
    if name not in CNN_ZOO:
        raise KeyError(f"unknown CNN {name!r}; available: {sorted(CNN_ZOO)}")
    return CNN_ZOO[name](**kw)
