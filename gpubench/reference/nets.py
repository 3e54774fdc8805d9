"""Frozen plain copies of the nets the benchmark's cells run, for inference:
FusionNet v3 (with and without the semantic head) and AdapNet++ stage 2.

Copied from ``segfusion_tpu_torch/models/{layers,fusionnet,adapnet}.py``
(inference paths only), with the submodule names kept so that one state
dict loads into both. Plain ``torch`` operations in float32; the caller
turns TF32 off (``plain_precision``). Every convolution can run through a
quantiser (``set_quantiser``), which is how the precision control is
built: the same nets with their convolution inputs and weights rounded to
a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FusionNetV3", "AdapNetStage2", "set_quantiser", "plain_precision",
           "fusion_net_for", "segmenter_for"]


@contextlib.contextmanager
def plain_precision():
    """Float32 products and convolutions without TF32 or reduced-precision
    reductions, restored after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    m.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


class Conv2d(nn.Conv2d):
    quantiser: Optional[Callable] = None

    def forward(self, x):
        w = self.weight
        if self.quantiser is not None:
            x, w = self.quantiser(x), self.quantiser(w)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    quantiser: Optional[Callable] = None

    def forward(self, x):
        w = self.weight
        if self.quantiser is not None:
            x, w = self.quantiser(x), self.quantiser(w)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm (running statistics), epsilon 1e-5."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def set_quantiser(module: nn.Module, fn: Optional[Callable]) -> nn.Module:
    """Run every convolution of ``module`` through ``fn`` (None: plain)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.quantiser = fn
    return module


# -- FusionNet v3 -------------------------------------------------------------

def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class Block(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, features, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 3, padding=1)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x):
        x = _lrelu(self.BatchNorm_0(self.Conv_0(x)))
        return _lrelu(self.BatchNorm_1(self.Conv_1(x)))


class Pred(nn.Module):
    def __init__(self, in_ch: int, features: int, n_points=None):
        super().__init__()
        self.final = n_points is not None
        self.Conv_0 = Conv2d(in_ch, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 1)
        if self.final:
            self.Conv_2 = Conv2d(features, n_points, 1)
        else:
            self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x):
        x = _lrelu(self.BatchNorm_0(self.Conv_0(x)))
        if not self.final:
            return _lrelu(self.BatchNorm_1(self.Conv_1(x)))
        return torch.tanh(self.Conv_2(_lrelu(self.Conv_1(x))))


class VortexPooling(nn.Module):
    def __init__(self, in_ch: int, mid: int, out: int,
                 rates: Sequence[int] = (1, 3, 9, 27)):
        super().__init__()
        self.rates = tuple(rates)
        self.Conv_0 = Conv2d(in_ch, out, 1)
        self.BatchNorm_0 = BatchNorm(out)
        for i, r in enumerate(self.rates):
            k = 1 + 4 * i
            chans = [(in_ch, mid, 1, 0, 1), (mid, mid, 3, r, r),
                     (mid, mid, 3, r, r), (mid, out, 1, 0, 1)]
            for j, (ci, co, ks, pad, dil) in enumerate(chans):
                self.add_module(f"Conv_{k + j}", Conv2d(
                    ci, co, ks, padding=pad, dilation=dil))
                self.add_module(f"BatchNorm_{k + j}", BatchNorm(co))
        last = 1 + 4 * len(self.rates)
        self.add_module(f"Conv_{last}",
                        Conv2d(out * (1 + len(self.rates)), out, 1))
        self.add_module(f"BatchNorm_{last}", BatchNorm(out))

    def _cbr(self, i, x):
        return F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))

    def forward(self, x):
        h, w = x.shape[-2:]
        g = self.BatchNorm_0(self.Conv_0(x.mean((2, 3), keepdim=True)))
        branches = [g.expand(-1, -1, h, w)]
        xp = x
        for i in range(len(self.rates)):
            if i:
                xp = F.avg_pool2d(xp, 3, 1, 1, count_include_pad=True)
            b = xp
            for j in range(4):
                b = self._cbr(1 + 4 * i + j, b)
            branches.append(b)
        last = 1 + 4 * len(self.rates)
        out = getattr(self, f"Conv_{last}")(torch.cat(branches, 1))
        return getattr(self, f"BatchNorm_{last}")(out)


class FusionHead(nn.Module):
    def __init__(self, n_ch: int, gf: int, pool_in: int):
        super().__init__()
        self.gf = gf
        for i in range(gf):
            self.add_module(f"Block_{i}", Block(n_ch * (i + 1), n_ch))
        self.VortexPooling_0 = VortexPooling(pool_in, n_ch, pool_in)

    def forward(self, x):
        for i in range(self.gf):
            x = torch.cat([x, getattr(self, f"Block_{i}")(x)], 1)
        return self.VortexPooling_0(x)


class FusionNetV3(nn.Module):
    """NHWC dict in (tsdf_values, tsdf_weights (B, H, W, n_points),
    tsdf_frame and semantic_frame (B, H, W, 1)); (B, H*W, n_points) out."""

    def __init__(self, n_points: int = 9, use_semantics: bool = False,
                 output_scale: float = 1.0, growth_factor: int = 6):
        super().__init__()
        self.use_semantics = use_semantics
        self.output_scale = float(output_scale)
        n_ch = 2 * n_points + 1
        gf = growth_factor - 1
        pool_in = n_ch * (gf + 1)
        if use_semantics:
            self.head_tsdf = FusionHead(n_ch, gf, pool_in)
            self.head_sem = FusionHead(n_ch, gf, pool_in)
        else:
            self.FusionHead_0 = FusionHead(n_ch, gf, pool_in)
        heads = 2 if use_semantics else 1
        self.VortexPooling_0 = VortexPooling(heads * pool_in, n_ch, pool_in)
        self.n_preds = gf
        in_ch = pool_in
        for i in range(gf):
            feats = (gf - i) * n_ch
            self.add_module(f"Pred_{i}", Pred(
                in_ch, feats, n_points if i == gf - 1 else None))
            in_ch = feats

    @staticmethod
    def _input(data, keys):
        return torch.cat([data[k].float() for k in keys], -1).permute(
            0, 3, 1, 2)

    def forward(self, data) -> torch.Tensor:
        x = self._input(data, ["tsdf_values", "tsdf_weights", "tsdf_frame"])
        if self.use_semantics:
            xs = self._input(data, ["tsdf_values", "tsdf_weights",
                                    "semantic_frame"])
            y = torch.cat([self.head_tsdf(x), self.head_sem(xs)], 1)
        else:
            y = self.FusionHead_0(x)
        y = self.VortexPooling_0(y)
        for i in range(self.n_preds):
            y = getattr(self, f"Pred_{i}")(y)
        y = (self.output_scale * y).permute(0, 2, 3, 1)
        return y.reshape(y.shape[0], -1, y.shape[-1])


# -- AdapNet++ stage 2 --------------------------------------------------------

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


def fusion_net_for(model_cfg) -> FusionNetV3:
    """The reference FusionNet of a FUSION_MODEL section (v3 only)."""
    if model_cfg["name"] != "v3":
        raise ValueError("the reference holds FusionNet v3 only")
    return FusionNetV3(n_points=int(model_cfg["n_points"]),
                       use_semantics=bool(model_cfg["use_semantics"]),
                       output_scale=float(model_cfg["output_scale"]),
                       growth_factor=int(model_cfg["growth_factor"]))


def segmenter_for(seg_cfg) -> AdapNetStage2:
    """The reference AdapNet++ of a SEMANTIC_2D_MODEL section (stage 2)."""
    if int(seg_cfg["stage"]) != 2:
        raise ValueError("the reference holds AdapNet++ stage 2 only")
    return AdapNetStage2(int(seg_cfg["n_classes"]))
