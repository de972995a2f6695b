"""Inception V3 and Inception-ResNet-v2 (port of
``edgevisiontransformer_tpu/models/cnn/inception.py``; the reference zoo
includes the keras-applications models, its ``cnn_zoo.py:50-119``).

Standard 299x299 architectures; they accept 224 too (spatial dims just
shrink), and 75x75 is the smallest input both take.  Max pools are
``VALID`` and average pools ``SAME`` counting the padded zeros, as Flax's
``nn.max_pool`` / ``nn.avg_pool(padding="SAME")``; every BatchNorm's
epsilon is 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import CNN, Conv, ConvBN, ConvBNAct, Dense, FlaxNamed, avg_pool, max_pool


class InceptionA(FlaxNamed):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1 = [self.sub(ConvBNAct(cin, 64, 1))]
        self.b5 = [self.sub(ConvBNAct(cin, 48, 1)), self.sub(ConvBNAct(48, 64, 5))]
        self.b3 = [self.sub(ConvBNAct(cin, 64, 1)), self.sub(ConvBNAct(64, 96, 3)),
                   self.sub(ConvBNAct(96, 96, 3))]
        self.bp = self.sub(ConvBNAct(cin, pool_features, 1))

    def forward(self, x):
        outs = []
        for branch in (self.b1, self.b5, self.b3):
            h = x
            for layer in branch:
                h = layer(h)
            outs.append(h)
        outs.append(self.bp(avg_pool(x, 3, 1, padding="SAME")))
        return torch.cat(outs, dim=1)


class InceptionB(FlaxNamed):
    def __init__(self, cin: int):
        super().__init__()
        self.b3 = self.sub(ConvBNAct(cin, 384, 3, 2, padding="VALID"))
        self.bd = [self.sub(ConvBNAct(cin, 64, 1)), self.sub(ConvBNAct(64, 96, 3)),
                   self.sub(ConvBNAct(96, 96, 3, 2, padding="VALID"))]

    def forward(self, x):
        bd = x
        for layer in self.bd:
            bd = layer(bd)
        return torch.cat([self.b3(x), bd, max_pool(x, 3, 2)], dim=1)


class InceptionC(FlaxNamed):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.b1 = self.sub(ConvBNAct(cin, 192, 1))
        self.b7 = [self.sub(ConvBNAct(cin, c7, 1)), ConvBN(self, c7, c7, 1, 7),
                   ConvBN(self, c7, 192, 7, 1)]
        self.b77 = [self.sub(ConvBNAct(cin, c7, 1)), ConvBN(self, c7, c7, 7, 1),
                    ConvBN(self, c7, c7, 1, 7), ConvBN(self, c7, c7, 7, 1),
                    ConvBN(self, c7, 192, 1, 7)]
        self.bp = self.sub(ConvBNAct(cin, 192, 1))

    def forward(self, x):
        outs = [self.b1(x)]
        for branch in (self.b7, self.b77):
            h = x
            for layer in branch:
                h = layer(h)
            outs.append(h)
        outs.append(self.bp(avg_pool(x, 3, 1, padding="SAME")))
        return torch.cat(outs, dim=1)


class InceptionD(FlaxNamed):
    def __init__(self, cin: int):
        super().__init__()
        self.b3 = [self.sub(ConvBNAct(cin, 192, 1)),
                   self.sub(ConvBNAct(192, 320, 3, 2, padding="VALID"))]
        self.b7 = [self.sub(ConvBNAct(cin, 192, 1)), ConvBN(self, 192, 192, 1, 7),
                   ConvBN(self, 192, 192, 7, 1),
                   self.sub(ConvBNAct(192, 192, 3, 2, padding="VALID"))]

    def forward(self, x):
        outs = []
        for branch in (self.b3, self.b7):
            h = x
            for layer in branch:
                h = layer(h)
            outs.append(h)
        outs.append(max_pool(x, 3, 2))
        return torch.cat(outs, dim=1)


class InceptionE(FlaxNamed):
    def __init__(self, cin: int):
        super().__init__()
        self.b1 = self.sub(ConvBNAct(cin, 320, 1))
        self.b3 = self.sub(ConvBNAct(cin, 384, 1))
        self.b3_split = [ConvBN(self, 384, 384, 1, 3), ConvBN(self, 384, 384, 3, 1)]
        self.bd = [self.sub(ConvBNAct(cin, 448, 1)), self.sub(ConvBNAct(448, 384, 3))]
        self.bd_split = [ConvBN(self, 384, 384, 1, 3), ConvBN(self, 384, 384, 3, 1)]
        self.bp = self.sub(ConvBNAct(cin, 192, 1))

    def forward(self, x):
        b3 = self.b3(x)
        bd = self.bd[1](self.bd[0](x))
        return torch.cat([self.b1(x), *(conv(b3) for conv in self.b3_split),
                          *(conv(bd) for conv in self.bd_split),
                          self.bp(avg_pool(x, 3, 1, padding="SAME"))], dim=1)


class InceptionResNetBlock(FlaxNamed):
    """Residual Inception block (block35 / block17 / block8 of
    keras-applications InceptionResNetV2, the reference zoo's
    ``get_inception_resnetv2``): branches -> 1x1 linear "up" conv ->
    x + scale*up, optional relu."""

    def __init__(self, cin: int, kind: str, scale: float, relu_out: bool = True):
        super().__init__()
        self.scale, self.relu_out = scale, relu_out
        if kind == "block35":
            self.branches = [[ConvBN(self, cin, 32, 1, 1)],
                             [ConvBN(self, cin, 32, 1, 1), ConvBN(self, 32, 32, 3, 3)],
                             [ConvBN(self, cin, 32, 1, 1), ConvBN(self, 32, 48, 3, 3),
                              ConvBN(self, 48, 64, 3, 3)]]
            mixed = 128
        elif kind == "block17":
            self.branches = [[ConvBN(self, cin, 192, 1, 1)],
                             [ConvBN(self, cin, 128, 1, 1), ConvBN(self, 128, 160, 1, 7),
                              ConvBN(self, 160, 192, 7, 1)]]
            mixed = 384
        else:  # block8
            self.branches = [[ConvBN(self, cin, 192, 1, 1)],
                             [ConvBN(self, cin, 192, 1, 1), ConvBN(self, 192, 224, 1, 3),
                              ConvBN(self, 224, 256, 3, 1)]]
            mixed = 448
        # "up" projection: plain conv with bias, no BN, linear (keras semantics)
        self.up = self.sub(Conv(mixed, cin, (1, 1)))

    def forward(self, x):
        outs = []
        for branch in self.branches:
            h = x
            for layer in branch:
                h = layer(h)
            outs.append(h)
        out = x + self.scale * self.up(torch.cat(outs, dim=1))
        return F.relu(out) if self.relu_out else out


class InceptionResNetV2(CNN):
    """Inception-ResNet-v2 (the reference's keras-applications model, 299x299;
    ~55.9M params).  Stem -> mixed_5b -> 10x block35 -> reduction-A ->
    20x block17 -> reduction-B -> 10x block8 -> conv 1536 -> GAP -> fc."""

    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.stem = [ConvBN(self, 3, 32, 3, 3, stride=2, padding="VALID"),
                     ConvBN(self, 32, 32, 3, 3, padding="VALID"),
                     ConvBN(self, 32, 64, 3, 3)]
        self.stem2 = [ConvBN(self, 64, 80, 1, 1, padding="VALID"),
                      ConvBN(self, 80, 192, 3, 3, padding="VALID")]
        self.mixed_5b = [[ConvBN(self, 192, 96, 1, 1)],
                         [ConvBN(self, 192, 48, 1, 1), ConvBN(self, 48, 64, 5, 5)],
                         [ConvBN(self, 192, 64, 1, 1), ConvBN(self, 64, 96, 3, 3),
                          ConvBN(self, 96, 96, 3, 3)]]
        self.mixed_5b_pool = ConvBN(self, 192, 64, 1, 1)
        self.block35 = [self.sub(InceptionResNetBlock(320, "block35", 0.17)) for _ in range(10)]
        self.mixed_6a = [[ConvBN(self, 320, 384, 3, 3, stride=2, padding="VALID")],
                         [ConvBN(self, 320, 256, 1, 1), ConvBN(self, 256, 256, 3, 3),
                          ConvBN(self, 256, 384, 3, 3, stride=2, padding="VALID")]]
        self.block17 = [self.sub(InceptionResNetBlock(1088, "block17", 0.10)) for _ in range(20)]
        self.mixed_7a = [[ConvBN(self, 1088, 256, 1, 1),
                          ConvBN(self, 256, 384, 3, 3, stride=2, padding="VALID")],
                         [ConvBN(self, 1088, 256, 1, 1),
                          ConvBN(self, 256, 288, 3, 3, stride=2, padding="VALID")],
                         [ConvBN(self, 1088, 256, 1, 1), ConvBN(self, 256, 288, 3, 3),
                          ConvBN(self, 288, 320, 3, 3, stride=2, padding="VALID")]]
        self.block8 = [self.sub(InceptionResNetBlock(2080, "block8", 0.20)) for _ in range(9)]
        self.block8.append(self.sub(InceptionResNetBlock(2080, "block8", 1.0, relu_out=False)))
        self.last = ConvBN(self, 2080, 1536, 1, 1)
        self.fc = self.sub(Dense(1536, num_classes))
        self._place(device, generator)

    @staticmethod
    def _branches(branches, x):
        outs = []
        for branch in branches:
            h = x
            for layer in branch:
                h = layer(h)
            outs.append(h)
        return outs

    def _forward(self, x):
        for layer in self.stem:
            x = layer(x)
        x = max_pool(x, 3, 2)
        for layer in self.stem2:
            x = layer(x)
        x = max_pool(x, 3, 2)
        x = torch.cat([*self._branches(self.mixed_5b, x),
                       self.mixed_5b_pool(avg_pool(x, 3, 1, padding="SAME"))], dim=1)  # 320
        for block in self.block35:
            x = block(x)
        x = torch.cat([*self._branches(self.mixed_6a, x), max_pool(x, 3, 2)], dim=1)  # 1088
        for block in self.block17:
            x = block(x)
        x = torch.cat([*self._branches(self.mixed_7a, x), max_pool(x, 3, 2)], dim=1)  # 2080
        for block in self.block8:
            x = block(x)
        return self.fc(self.last(x).mean(dim=(2, 3)))


class InceptionV3(CNN):
    def __init__(self, num_classes: int = 1000, *, device="cuda", generator=None):
        super().__init__(num_classes)
        self.stem = [self.sub(ConvBNAct(3, 32, 3, 2, padding="VALID")),
                     self.sub(ConvBNAct(32, 32, 3, padding="VALID")),
                     self.sub(ConvBNAct(32, 64, 3))]
        self.stem2 = [self.sub(ConvBNAct(64, 80, 1, padding="VALID")),
                      self.sub(ConvBNAct(80, 192, 3, padding="VALID"))]
        self.blocks = [self.sub(InceptionA(192, 32)), self.sub(InceptionA(256, 64)),
                       self.sub(InceptionA(288, 64)), self.sub(InceptionB(288)),
                       self.sub(InceptionC(768, 128)), self.sub(InceptionC(768, 160)),
                       self.sub(InceptionC(768, 160)), self.sub(InceptionC(768, 192)),
                       self.sub(InceptionD(768)), self.sub(InceptionE(1280)),
                       self.sub(InceptionE(2048))]
        self.fc = self.sub(Dense(2048, num_classes))
        self._place(device, generator)

    def _forward(self, x):
        for layer in self.stem:
            x = layer(x)
        x = max_pool(x, 3, 2)
        for layer in self.stem2:
            x = layer(x)
        x = max_pool(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(2, 3)))
