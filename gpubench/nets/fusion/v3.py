"""FusionNet v3 (``FUSION_MODEL.name: v3``), with and without the semantic
head: the port's module and its plain reference.

``port`` builds the port's module through its own factory; ``reference``
is a frozen plain copy of ``segfusion_tpu_torch/models/{layers,
fusionnet}.py`` (the inference path), with the submodule names kept so
that one state dict loads into both. The reference imports nothing of the
port: NHWC dict in (tsdf_values, tsdf_weights (B, H, W, n_points),
tsdf_frame and semantic_frame (B, H, W, 1)), (B, H*W, n_points) out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.layers import BatchNorm, Conv2d


def port(section):
    """The port's FusionNet of the port's FUSION_MODEL section."""
    from segfusion_tpu_torch.models.fusionnet import build_fusion_net
    return build_fusion_net(section)


def reference(section) -> nn.Module:
    """The plain reference of a FUSION_MODEL section."""
    return FusionNetV3(n_points=int(section["n_points"]),
                       use_semantics=bool(section["use_semantics"]),
                       output_scale=float(section["output_scale"]),
                       growth_factor=int(section["growth_factor"]))


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
