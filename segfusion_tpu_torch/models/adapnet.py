"""AdapNet++ stage 2: RGB + depth semantic segmentation.

Port of ``segfusion_tpu/models/adapnet.py`` (stage 2, the model of the
joint headline; stage 1 comes with the segmentation CLIs): two
multi-dilation ResNet-50 encoders (built by hand), eASPP, SSMA fusion and
the 3-stage decoder with gated skips.
Submodules carry the Flax auto-names so ``utils/convert.py`` loads a Flax
tree by name. Flax's ``ConvTranspose(padding="SAME")`` applies its kernel
unflipped; here it is ``nn.ConvTranspose2d`` with ``padding=(k - s) // 2``
and the converter flips the kernel. The decoder's two auxiliary heads
only serve training: their parameters are kept (and loaded) but not
evaluated.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Bottleneck", "BottleneckSSMA", "Encoder", "EASPP", "Decoder",
           "SSMA", "AdapNet", "build_adapnet", "SegmenterAdapter"]


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _conv(ci, co, k, stride=1, dil=1, bias=True):
    pad = dil * (k - 1) // 2
    return nn.Conv2d(ci, co, k, stride=stride, padding=pad, dilation=dil,
                     bias=bias)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck (1x1 -> 3x3 -> 1x1, x4 expansion)."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        out = 4 * mid
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = _bn(mid)
        self.Conv_1 = _conv(mid, mid, 3, stride=stride, bias=False)
        self.BatchNorm_1 = _bn(mid)
        self.Conv_2 = _conv(mid, out, 1, bias=False)
        self.BatchNorm_2 = _bn(out)
        self.has_down = project or stride != 1 or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, stride=stride,
                                         bias=False)
            self.BatchNorm_3 = _bn(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        res = (self.BatchNorm_3(self.downsample_conv(x)) if self.has_down
               else x)
        return F.relu(y + res)


class BottleneckSSMA(nn.Module):
    """Multi-dilation unit: 1x1 -> two parallel dilated 3x3 branches
    (r1, r2) of d3/2 channels each -> concat -> 1x1 to ``out``."""

    def __init__(self, in_ch: int, mid: int, r1: int, r2: int, d3: int,
                 out: int, project: bool = False, drop_out: bool = False,
                 drop_rate: float = 0.5):
        super().__init__()
        half = d3 // 2
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = _bn(mid)
        self.Conv_1 = _conv(mid, half, 3, dil=r1, bias=False)
        self.BatchNorm_1 = _bn(half)
        self.Conv_2 = _conv(mid, half, 3, dil=r2, bias=False)
        self.BatchNorm_2 = _bn(half)
        self.Conv_3 = _conv(d3, out, 1, bias=False)
        self.BatchNorm_3 = _bn(out)
        self.has_down = project or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, bias=False)
            self.BatchNorm_4 = _bn(out)
        self.drop = nn.Dropout(drop_rate) if drop_out else nn.Identity()

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        a = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        b = F.relu(self.BatchNorm_2(self.Conv_2(y)))
        y = self.BatchNorm_3(self.Conv_3(torch.cat([a, b], 1)))
        res = (self.BatchNorm_4(self.downsample_conv(x)) if self.has_down
               else x)
        return self.drop(F.relu(y + res))


class Encoder(nn.Module):
    """ResNet-50 with the AdapNet++ surgery, output stride 16. Returns
    (features 2048ch @ /16, skip2 24ch @ /4, skip1 24ch @ /8)."""

    def __init__(self, resn50_dropout: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = _bn(64)
        blocks = [(64, 64, 1, True), (256, 64, 1, False),
                  (256, 64, 1, False), (256, 128, 2, False),
                  (512, 128, 1, False), (512, 128, 1, False),
                  (512, 256, 2, False), (1024, 256, 1, False)]
        for i, (ci, mid, stride, proj) in enumerate(blocks):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(ci, mid, stride, proj))
        ssma = [(512, 128, 1, 2, 64, 512, False, False)]
        ssma += [(1024, 256, 1, r2, 256, 1024, False,
                  i == 0 and resn50_dropout)
                 for i, r2 in enumerate((2, 16, 8, 4))]
        ssma += [(1024, 512, 2, 4, 512, 2048, True, False),
                 (2048, 512, 2, 8, 512, 2048, False, False),
                 (2048, 512, 2, 16, 512, 2048, False, False)]
        for i, (ci, mid, r1, r2, d3, out, proj, drop) in enumerate(ssma):
            self.add_module(f"BottleneckSSMA_{i}", BottleneckSSMA(
                ci, mid, r1, r2, d3, out, project=proj, drop_out=drop))
        self.Conv_1 = nn.Conv2d(256, 24, 1)
        self.BatchNorm_1 = _bn(24)
        self.Conv_2 = nn.Conv2d(512, 24, 1)
        self.BatchNorm_2 = _bn(24)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(3):                                  # layer1
            x = getattr(self, f"Bottleneck_{i}")(x)
        skip2 = self.BatchNorm_1(self.Conv_1(x))
        for i in range(3, 6):                               # layer2
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = self.BottleneckSSMA_0(x)
        skip1 = self.BatchNorm_2(self.Conv_2(x))
        for i in range(6, 8):                               # layer3
            x = getattr(self, f"Bottleneck_{i}")(x)
        for i in range(1, 8):                               # layer3/4
            x = getattr(self, f"BottleneckSSMA_{i}")(x)
        return x, skip2, skip1


class EASPP(nn.Module):
    """Efficient ASPP: 1x1 branch, 3 cascaded atrous branches (rates
    3/6/12), image pooling (no BN), concat + 1x1."""

    def __init__(self, in_ch: int = 2048, mid: int = 64, out: int = 256,
                 rates: Sequence[int] = (3, 6, 12)):
        super().__init__()
        self.rates = tuple(rates)
        self.Conv_0 = nn.Conv2d(in_ch, out, 1)
        self.BatchNorm_0 = _bn(out)
        for r_i, r in enumerate(self.rates):
            k = 1 + 4 * r_i
            specs = [(in_ch, mid, 1, 1), (mid, mid, 3, r), (mid, mid, 3, r),
                     (mid, out, 1, 1)]
            for j, (ci, co, ks, dil) in enumerate(specs):
                self.add_module(f"Conv_{k + j}", _conv(ci, co, ks, dil=dil))
                self.add_module(f"BatchNorm_{k + j}", _bn(co))
        n = 1 + 4 * len(self.rates)
        self.add_module(f"Conv_{n}", nn.Conv2d(in_ch, out, 1))  # pooling
        self.add_module(f"Conv_{n + 1}",
                        nn.Conv2d(out * (2 + len(self.rates)), out, 1))
        self.add_module(f"BatchNorm_{n}", _bn(out))

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
    """3-stage decoder with two skips, each gated by the global context of
    the decoder features. Returns the full-resolution logits (f32)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_0 = _bn(256)
        self.Conv_0 = nn.Conv2d(256, n_classes, 1)        # aux head 1
        self.BatchNorm_1 = _bn(n_classes)
        self.fuse_conv1 = nn.Conv2d(256, 24, 1)
        self.fuse_conv2 = nn.Conv2d(256, 24, 1)
        self.Conv_1 = _conv(280, 256, 3)
        self.BatchNorm_2 = _bn(256)
        self.Conv_2 = _conv(256, 256, 3)
        self.BatchNorm_3 = _bn(256)
        self.ConvTranspose_1 = nn.ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_4 = _bn(256)
        self.Conv_3 = nn.Conv2d(256, n_classes, 1)        # aux head 2
        self.BatchNorm_5 = _bn(n_classes)
        self.Conv_4 = _conv(280, 256, 3)
        self.BatchNorm_6 = _bn(256)
        self.Conv_5 = _conv(256, 256, 3)
        self.BatchNorm_7 = _bn(256)
        self.Conv_6 = nn.Conv2d(256, n_classes, 1)
        self.BatchNorm_8 = _bn(n_classes)
        self.ConvTranspose_2 = nn.ConvTranspose2d(n_classes, n_classes, 8,
                                                  4, 2)
        self.BatchNorm_9 = _bn(n_classes)

    @staticmethod
    def _skip(x, skip, gate):
        g = F.relu(gate(x.mean((2, 3), keepdim=True)))
        return torch.cat([x, g * skip.to(x.dtype)], 1)

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
        return self.BatchNorm_9(self.ConvTranspose_2(x)).float()


class SSMA(nn.Module):
    """Self-supervised modality attention fusion of two feature maps."""

    def __init__(self, features: int, bottleneck: int):
        super().__init__()
        reduce = features // bottleneck
        self.Conv_0 = _conv(2 * features, reduce, 3)
        self.Conv_1 = _conv(reduce, 2 * features, 3)
        self.Conv_2 = _conv(2 * features, features, 3)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x1, x2):
        x12 = torch.cat([x1, x2], 1)
        g = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(x12))))
        return self.BatchNorm_0(self.Conv_2(x12 * g))


class AdapNet(nn.Module):
    """Stage 2: RGB and depth encoders fused by SSMA at the bottleneck and
    both skips. NCHW in, NCHW f32 logits out."""

    def __init__(self, n_classes: int, resn50_dropout: bool = True):
        super().__init__()
        self.encoder_mod1 = Encoder(resn50_dropout)
        self.encoder_mod2 = Encoder(resn50_dropout)
        self.eASPP_mod1 = EASPP()
        self.eASPP_mod2 = EASPP()
        self.ssma_s2 = SSMA(24, 6)
        self.ssma_s1 = SSMA(24, 6)
        self.ssma_res = SSMA(256, 16)
        self.decoder = Decoder(n_classes)

    def forward(self, rgb, depth):
        m1, s2_1, s1_1 = self.encoder_mod1(rgb)
        m2, s2_2, s1_2 = self.encoder_mod2(depth)
        skip2 = self.ssma_s2(s2_1, s2_2)
        skip1 = self.ssma_s1(s1_1, s1_2)
        x = self.ssma_res(self.eASPP_mod1(m1), self.eASPP_mod2(m2))
        return self.decoder(x, skip1, skip2)


def build_adapnet(config) -> AdapNet:
    """Factory from the SEMANTIC_2D_MODEL config section (stage 2)."""
    if int(config.get("stage", 1)) != 2:
        raise ValueError("the port has AdapNet++ stage 2 only")
    return AdapNet(n_classes=int(config.n_classes),
                   resn50_dropout=bool(config.get("resn50_dropout", True)))


class SegmenterAdapter:
    """Pipeline-facing adapter: NHWC frames in, NHWC logits out. ``image``
    is (h, w, 3) in 0..255, ``depth`` (h, w); the image is scaled to [0, 1]
    and the depth repeated to 3 channels (reference normalisation)."""

    def __init__(self, model: AdapNet):
        self.model = model

    def apply_fn(self, image, depth):
        return self.apply_fn_batched(image[None], depth[None])[0]

    @torch.no_grad()
    def apply_fn_batched(self, images, depths):
        """(B, h, w, 3) images, (B, h, w) depths -> (B, h, w, C) f32
        logits. Inference BatchNorm: each sample independent of the
        batch."""
        dtype = self.model.encoder_mod1.Conv_0.weight.dtype
        img = (images / 255.0).permute(0, 3, 1, 2).to(dtype)
        dep = depths[:, None].expand(-1, 3, -1, -1).to(dtype)
        return self.model(img, dep).permute(0, 2, 3, 1)
