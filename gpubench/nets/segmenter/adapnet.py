"""AdapNet++ stage 2 (``SEMANTIC_2D_MODEL.name: adapnet``, the name a
section without one takes): the port's module, the object ``Pipeline``
takes, and the plain reference.

``port`` builds the port's module through its own factory and
``pipeline_segmenter`` wraps it in the port's ``SegmenterAdapter``;
``reference`` is a frozen plain copy of ``segfusion_tpu_torch/models/
{layers,adapnet}.py`` (the inference path), with the submodule names kept
so that one state dict loads into both. The reference imports nothing of
the port.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.layers import BatchNorm, Conv2d, ConvTranspose2d


def port(section):
    """The port's AdapNet++ of the port's SEMANTIC_2D_MODEL section."""
    from segfusion_tpu_torch.models.adapnet import build_adapnet
    return build_adapnet(section)


def pipeline_segmenter(net):
    """What ``Pipeline`` takes as its segmenter: ``net`` behind the port's
    adapter."""
    from segfusion_tpu_torch.models.adapnet import SegmenterAdapter
    return SegmenterAdapter(net)


def reference(section) -> nn.Module:
    """The plain reference of a SEMANTIC_2D_MODEL section (stage 2)."""
    if int(section["stage"]) != 2:
        raise ValueError("the reference holds AdapNet++ stage 2 only")
    return AdapNetStage2(int(section["n_classes"]))


def _conv(ci, co, k, stride=1, dil=1, bias=True):
    return Conv2d(ci, co, k, stride=stride, padding=dil * (k - 1) // 2,
                  dilation=dil, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        out = 4 * mid
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = _conv(mid, mid, 3, stride=stride, bias=False)
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = _conv(mid, out, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(out)
        self.has_down = project or stride != 1 or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, stride=stride,
                                         bias=False)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        res = (self.BatchNorm_3(self.downsample_conv(x)) if self.has_down
               else x)
        return F.relu(y + res)


class BottleneckSSMA(nn.Module):
    def __init__(self, in_ch: int, mid: int, r1: int, r2: int, d3: int,
                 out: int, project: bool = False):
        super().__init__()
        half = d3 // 2
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = _conv(mid, half, 3, dil=r1, bias=False)
        self.BatchNorm_1 = BatchNorm(half)
        self.Conv_2 = _conv(mid, half, 3, dil=r2, bias=False)
        self.BatchNorm_2 = BatchNorm(half)
        self.Conv_3 = _conv(d3, out, 1, bias=False)
        self.BatchNorm_3 = BatchNorm(out)
        self.has_down = project or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, bias=False)
            self.BatchNorm_4 = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        a = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        b = F.relu(self.BatchNorm_2(self.Conv_2(y)))
        y = self.BatchNorm_3(self.Conv_3(torch.cat([a, b], 1)))
        res = (self.BatchNorm_4(self.downsample_conv(x)) if self.has_down
               else x)
        return F.relu(y + res)


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        blocks = [(64, 64, 1, True), (256, 64, 1, False),
                  (256, 64, 1, False), (256, 128, 2, False),
                  (512, 128, 1, False), (512, 128, 1, False),
                  (512, 256, 2, False), (1024, 256, 1, False)]
        for i, (ci, mid, stride, proj) in enumerate(blocks):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(ci, mid, stride, proj))
        ssma = [(512, 128, 1, 2, 64, 512, False)]
        ssma += [(1024, 256, 1, r2, 256, 1024, False) for r2 in (2, 16, 8, 4)]
        ssma += [(1024, 512, 2, 4, 512, 2048, True),
                 (2048, 512, 2, 8, 512, 2048, False),
                 (2048, 512, 2, 16, 512, 2048, False)]
        for i, (ci, mid, r1, r2, d3, out, proj) in enumerate(ssma):
            self.add_module(f"BottleneckSSMA_{i}", BottleneckSSMA(
                ci, mid, r1, r2, d3, out, project=proj))
        self.Conv_1 = Conv2d(256, 24, 1)
        self.BatchNorm_1 = BatchNorm(24)
        self.Conv_2 = Conv2d(512, 24, 1)
        self.BatchNorm_2 = BatchNorm(24)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(3):
            x = getattr(self, f"Bottleneck_{i}")(x)
        skip2 = self.BatchNorm_1(self.Conv_1(x))
        for i in range(3, 6):
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = self.BottleneckSSMA_0(x)
        skip1 = self.BatchNorm_2(self.Conv_2(x))
        for i in range(6, 8):
            x = getattr(self, f"Bottleneck_{i}")(x)
        for i in range(1, 8):
            x = getattr(self, f"BottleneckSSMA_{i}")(x)
        return x, skip2, skip1


class EASPP(nn.Module):
    def __init__(self, in_ch: int = 2048, mid: int = 64, out: int = 256,
                 rates: Sequence[int] = (3, 6, 12)):
        super().__init__()
        self.rates = tuple(rates)
        self.Conv_0 = Conv2d(in_ch, out, 1)
        self.BatchNorm_0 = BatchNorm(out)
        for r_i, r in enumerate(self.rates):
            k = 1 + 4 * r_i
            specs = [(in_ch, mid, 1, 1), (mid, mid, 3, r), (mid, mid, 3, r),
                     (mid, out, 1, 1)]
            for j, (ci, co, ks, dil) in enumerate(specs):
                self.add_module(f"Conv_{k + j}", _conv(ci, co, ks, dil=dil))
                self.add_module(f"BatchNorm_{k + j}", BatchNorm(co))
        n = 1 + 4 * len(self.rates)
        self.add_module(f"Conv_{n}", Conv2d(in_ch, out, 1))
        self.add_module(f"Conv_{n + 1}",
                        Conv2d(out * (2 + len(self.rates)), out, 1))
        self.add_module(f"BatchNorm_{n}", BatchNorm(out))

    def forward(self, x):
        h, w = x.shape[-2:]
        branches = [F.relu(self.BatchNorm_0(self.Conv_0(x)))]
        for r_i in range(len(self.rates)):
            y = x
            for j in range(4):
                i = 1 + 4 * r_i + j
                y = F.relu(getattr(self, f"BatchNorm_{i}")(
                    getattr(self, f"Conv_{i}")(y)))
            branches.append(y)
        n = 1 + 4 * len(self.rates)
        g = F.relu(getattr(self, f"Conv_{n}")(x.mean((2, 3), keepdim=True)))
        branches.append(g.expand(-1, -1, h, w))
        y = getattr(self, f"Conv_{n + 1}")(torch.cat(branches, 1))
        return F.relu(getattr(self, f"BatchNorm_{n}")(y))


class Decoder(nn.Module):
    """The stage-2 decoder (skips gated by the features' global context),
    the final head only."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_0 = BatchNorm(256)
        self.Conv_0 = Conv2d(256, n_classes, 1)       # aux heads: unused
        self.BatchNorm_1 = BatchNorm(n_classes)
        self.fuse_conv1 = Conv2d(256, 24, 1)
        self.fuse_conv2 = Conv2d(256, 24, 1)
        self.Conv_1 = _conv(280, 256, 3)
        self.BatchNorm_2 = BatchNorm(256)
        self.Conv_2 = _conv(256, 256, 3)
        self.BatchNorm_3 = BatchNorm(256)
        self.ConvTranspose_1 = ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_4 = BatchNorm(256)
        self.Conv_3 = Conv2d(256, n_classes, 1)
        self.BatchNorm_5 = BatchNorm(n_classes)
        self.Conv_4 = _conv(280, 256, 3)
        self.BatchNorm_6 = BatchNorm(256)
        self.Conv_5 = _conv(256, 256, 3)
        self.BatchNorm_7 = BatchNorm(256)
        self.Conv_6 = Conv2d(256, n_classes, 1)
        self.BatchNorm_8 = BatchNorm(n_classes)
        self.ConvTranspose_2 = ConvTranspose2d(n_classes, n_classes, 8, 4, 2)
        self.BatchNorm_9 = BatchNorm(n_classes)

    @staticmethod
    def _skip(x, skip, gate):
        g = F.relu(gate(x.mean((2, 3), keepdim=True)))
        return torch.cat([x, g * skip], 1)

    def forward(self, x, skip1, skip2):
        x = F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))
        x = self._skip(x, skip1, self.fuse_conv1)
        x = F.relu(self.BatchNorm_2(self.Conv_1(x)))
        x = F.relu(self.BatchNorm_3(self.Conv_2(x)))
        x = self.BatchNorm_4(self.ConvTranspose_1(x))
        x = self._skip(x, skip2, self.fuse_conv2)
        x = F.relu(self.BatchNorm_6(self.Conv_4(x)))
        x = F.relu(self.BatchNorm_7(self.Conv_5(x)))
        x = self.BatchNorm_8(self.Conv_6(x))
        return self.BatchNorm_9(self.ConvTranspose_2(x))


class SSMA(nn.Module):
    def __init__(self, features: int, bottleneck: int):
        super().__init__()
        reduce = features // bottleneck
        self.Conv_0 = _conv(2 * features, reduce, 3)
        self.Conv_1 = _conv(reduce, 2 * features, 3)
        self.Conv_2 = _conv(2 * features, features, 3)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x1, x2):
        x12 = torch.cat([x1, x2], 1)
        g = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(x12))))
        return self.BatchNorm_0(self.Conv_2(x12 * g))


class AdapNetStage2(nn.Module):
    """RGB and depth ResNet-50 encoders, SSMA at the bottleneck and both
    skips, the gated decoder: (B, h, w, 3) image in 0..255 and (B, h, w)
    depth -> (B, h, w, C) logits, the port's ``SegmenterAdapter``
    normalisation (image / 255, depth repeated to 3 channels)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.encoder_mod1 = Encoder()
        self.encoder_mod2 = Encoder()
        self.eASPP_mod1 = EASPP()
        self.eASPP_mod2 = EASPP()
        self.ssma_s2 = SSMA(24, 6)
        self.ssma_s1 = SSMA(24, 6)
        self.ssma_res = SSMA(256, 16)
        self.decoder = Decoder(n_classes)

    def forward(self, images, depths):
        img = (images.float() / 255.0).permute(0, 3, 1, 2)
        dep = depths.float()[:, None].expand(-1, 3, -1, -1)
        m1, s2_1, s1_1 = self.encoder_mod1(img)
        m2, s2_2, s1_2 = self.encoder_mod2(dep)
        skip2 = self.ssma_s2(s2_1, s2_2)
        skip1 = self.ssma_s1(s1_1, s1_2)
        x = self.ssma_res(self.eASPP_mod1(m1), self.eASPP_mod2(m2))
        return self.decoder(x, skip1, skip2).permute(0, 2, 3, 1)
