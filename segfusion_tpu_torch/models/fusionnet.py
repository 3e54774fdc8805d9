"""FusionNet v1, v2 and v3: dense-connected 2D CNNs predicting per-ray
TSDF updates.

Port of ``segfusion_tpu/models/fusionnet.py``. Submodules carry the Flax
auto-names (``Conv_0``, ``BatchNorm_0``, ``Block_0``, ...) so
``utils/convert.py`` maps a Flax parameter tree onto the module by name.
The public input is the JAX package's NHWC dict; the convolutions run
NCHW inside.

The net computes in ``compute_dtype`` (default: its parameters' dtype),
through the layers of ``models/layers.py``: convolutions and the
inference BatchNorm cast their parameters to it, so a float32 net with a
bfloat16 ``compute_dtype`` (the trainer's f32 master weights) infers
bit-identically to the same net cast to bfloat16. In train mode BatchNorm
normalises with float32 batch statistics and moves its running averages
by Flax's momentum 0.99, and dropout drops whole channels, drawing from
the generator given to :meth:`FusionNetV3.set_dropout_generator`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dropout, set_dropout_generator

__all__ = ["BatchNorm", "Conv2d", "Dropout", "Block", "Pred",
           "VortexPooling", "FusionHead", "FusionNetV1", "FusionNetV2",
           "FusionNetV3", "build_fusion_net"]


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class Block(nn.Module):
    """conv3x3 -> BN -> LeakyReLU -> Dropout2d, twice."""

    def __init__(self, in_ch: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, features, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 3, padding=1)
        self.BatchNorm_1 = BatchNorm(features)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(_lrelu(self.BatchNorm_0(self.Conv_0(x))))
        return self.drop(_lrelu(self.BatchNorm_1(self.Conv_1(x))))


class Pred(nn.Module):
    """1x1-conv prediction stage; with ``n_points`` the final stage
    (conv-BN-lrelu-drop -> conv-lrelu -> conv(n_points) -> tanh)."""

    def __init__(self, in_ch: int, features: int, n_points=None,
                 dropout: float = 0.2):
        super().__init__()
        self.final = n_points is not None
        self.Conv_0 = Conv2d(in_ch, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 1)
        if self.final:
            self.Conv_2 = Conv2d(features, n_points, 1)
        else:
            self.BatchNorm_1 = BatchNorm(features)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(_lrelu(self.BatchNorm_0(self.Conv_0(x))))
        if not self.final:
            return self.drop(_lrelu(self.BatchNorm_1(self.Conv_1(x))))
        x = _lrelu(self.Conv_1(x))
        return torch.tanh(self.Conv_2(x)).float()


class VortexPooling(nn.Module):
    """Global-average branch + 4 dilated branches (rates 1, 3, 9, 27) over
    progressively 3x3-average-pooled inputs, concat + 1x1 fuse."""

    def __init__(self, in_ch: int, mid: int, out: int,
                 rates: Sequence[int] = (1, 3, 9, 27), dropout: float = 0.2):
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
        self.drop = Dropout(dropout)

    def _cbr(self, i, x):
        return F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))

    def forward(self, x):
        h, w = x.shape[-2:]
        # image-level branch: Flax normalises the broadcast map. BN
        # commutes with the broadcast: at inference it is per-channel
        # affine, in train mode the map's statistics over (N, H, W) are
        # those of the N per-sample values. (Over N = 1 they are exact:
        # the output is the BN bias and its gradient 0, where the map's
        # rounded sums leave Flax a noise gradient.)
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
        return self.drop(getattr(self, f"BatchNorm_{last}")(out))


class FusionHead(nn.Module):
    """Dense Blocks -> VortexPooling (one v3 head)."""

    def __init__(self, n_ch: int, gf: int, pool_in: int,
                 dropout: float = 0.2):
        super().__init__()
        self.gf = gf
        for i in range(gf):
            self.add_module(f"Block_{i}", Block(n_ch * (i + 1), n_ch,
                                                dropout))
        self.VortexPooling_0 = VortexPooling(pool_in, n_ch, pool_in,
                                             dropout=dropout)

    def forward(self, x):
        for i in range(self.gf):
            x = torch.cat([x, getattr(self, f"Block_{i}")(x)], 1)
        return self.VortexPooling_0(x)


class _FusionNet(nn.Module):
    """What the three nets share: the compute dtype, the dropout
    generator, the NHWC -> NCHW input and the scaled NHWC output."""

    compute_dtype: Optional[torch.dtype] = None

    def set_dropout_generator(self, generator: torch.Generator):
        """The generator every dropout layer draws from in train mode."""
        set_dropout_generator(self, generator)

    def _input(self, data, keys):
        dtype = self.compute_dtype or next(self.parameters()).dtype
        x = torch.cat([data[k] for k in keys], -1)
        return x.permute(0, 3, 1, 2).to(dtype)

    def _output(self, y):
        return (self.output_scale * y).permute(0, 2, 3, 1)

    def _preds(self, y):
        for i in range(self.n_preds):
            y = getattr(self, f"Pred_{i}")(y)
        return y

    def _add_preds(self, in_ch, n_ch, n_preds, n_points, dropout=0.2):
        self.n_preds = n_preds
        for i in range(n_preds):
            feats = (n_preds - i) * n_ch
            self.add_module(f"Pred_{i}", Pred(
                in_ch, feats, n_points if i == n_preds - 1 else None,
                dropout))
            in_ch = feats


def _frame_keys(use_semantics):
    keys = ["tsdf_values", "tsdf_weights", "tsdf_frame"]
    return keys + ["semantic_frame"] if use_semantics else keys


class FusionNetV1(_FusionNet):
    """Four dense Blocks -> four Preds (the reference's FusionNet_v1,
    repaired as the JAX package has it); the semantic frame, when used,
    is one more input channel. Dropout 0.2 throughout."""

    def __init__(self, n_points: int = 9, use_semantics: bool = False,
                 output_scale: float = 1.0):
        super().__init__()
        self.use_semantics = use_semantics
        self.output_scale = float(output_scale)
        n_ch = 2 * n_points + 1 + int(use_semantics)
        for i in range(4):
            self.add_module(f"Block_{i}", Block(n_ch * (i + 1), n_ch))
        self._add_preds(5 * n_ch, n_ch, 4, n_points)

    def forward(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self._input(data, _frame_keys(self.use_semantics))
        for i in range(4):
            x = torch.cat([x, getattr(self, f"Block_{i}")(x)], 1)
        return self._output(self._preds(x))


class FusionNetV2(_FusionNet):
    """growth_factor - 1 dense Blocks -> two VortexPoolings -> Preds (the
    reference's FusionNet_v2); the semantic frame, when used, is one more
    input channel. Dropout 0.2 throughout."""

    def __init__(self, n_points: int = 9, use_semantics: bool = False,
                 output_scale: float = 1.0, growth_factor: int = 6):
        super().__init__()
        self.use_semantics = use_semantics
        self.output_scale = float(output_scale)
        n_ch = 2 * n_points + 1 + int(use_semantics)
        self.gf = gf = growth_factor - 1
        pool_in = n_ch * (gf + 1)
        for i in range(gf):
            self.add_module(f"Block_{i}", Block(n_ch * (i + 1), n_ch))
        self.VortexPooling_0 = VortexPooling(pool_in, n_ch, pool_in)
        self.VortexPooling_1 = VortexPooling(pool_in, n_ch, pool_in)
        self._add_preds(pool_in, n_ch, gf, n_points)

    def forward(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self._input(data, _frame_keys(self.use_semantics))
        for i in range(self.gf):
            x = torch.cat([x, getattr(self, f"Block_{i}")(x)], 1)
        x = self.VortexPooling_1(self.VortexPooling_0(x))
        return self._output(self._preds(x))


class FusionNetV3(_FusionNet):
    """TSDF head (values + weights + depth frame) and optional semantic
    head (values + weights + semantic frame) -> third VortexPooling -> pred
    stack. Input: NHWC dict; output (B, H, W, n_points) f32.

    ``stack_heads`` (with semantics) is the JAX package's ``DualHead_0``:
    the two heads as one vmapped module whose leaves lead with a head axis
    of 2. The same function as two heads, so the port keeps two heads and
    ``utils/convert.py`` maps the stacked tree onto them both ways. As in
    the JAX package, stacked heads drop at 0.2 whatever ``dropout`` is."""

    def __init__(self, n_points: int = 9, use_semantics: bool = False,
                 output_scale: float = 1.0, growth_factor: int = 6,
                 dropout: float = 0.2, stack_heads: bool = False):
        super().__init__()
        self.use_semantics = use_semantics
        self.stack_heads = bool(stack_heads and use_semantics)
        self.output_scale = float(output_scale)
        n_ch = 2 * n_points + 1
        gf = growth_factor - 1
        pool_in = n_ch * (gf + 1)
        if use_semantics:
            head_dropout = 0.2 if self.stack_heads else dropout
            self.head_tsdf = FusionHead(n_ch, gf, pool_in, head_dropout)
            self.head_sem = FusionHead(n_ch, gf, pool_in, head_dropout)
        else:
            self.FusionHead_0 = FusionHead(n_ch, gf, pool_in, dropout)
        heads = 2 if use_semantics else 1
        self.VortexPooling_0 = VortexPooling(heads * pool_in, n_ch, pool_in,
                                             dropout=dropout)
        self._add_preds(pool_in, n_ch, gf, n_points, dropout)

    def forward(self, data: Dict[str, torch.Tensor]) -> torch.Tensor:
        x_tsdf = self._input(data, ["tsdf_values", "tsdf_weights",
                                    "tsdf_frame"])
        if self.use_semantics:
            x_sem = self._input(data, ["tsdf_values", "tsdf_weights",
                                       "semantic_frame"])
            y = torch.cat([self.head_tsdf(x_tsdf), self.head_sem(x_sem)], 1)
        else:
            y = self.FusionHead_0(x_tsdf)
        return self._output(self._preds(self.VortexPooling_0(y)))


def build_fusion_net(config) -> nn.Module:
    """Factory for the FUSION_MODEL config section: v1, v2 or v3. v1 and
    v2 take no ``dropout`` (they drop at 0.2); the JAX package's factory
    passes it to them too, which their Flax classes refuse."""
    kwargs = dict(n_points=int(config.n_points),
                  use_semantics=bool(config.use_semantics),
                  output_scale=float(config.output_scale))
    if config.name == "v1":
        return FusionNetV1(**kwargs)
    if config.name == "v2":
        return FusionNetV2(growth_factor=int(config.growth_factor), **kwargs)
    if config.name == "v3":
        return FusionNetV3(growth_factor=int(config.growth_factor),
                           dropout=float(config.get("dropout", 0.2)),
                           stack_heads=bool(config.get("stack_heads", False)),
                           **kwargs)
    raise ValueError(f"unknown fusion model {config.name!r}")
