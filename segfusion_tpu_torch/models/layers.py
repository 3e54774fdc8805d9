"""Flax-faithful layers that the port's nets share, and the convolution
backend their training steps run under.

The convolutions compute in their input's dtype, their parameters cast to
it, so a float32 net fed bfloat16 (the trainers' f32 master weights with a
bfloat16 compute dtype) infers bit-identically to the same net cast to
bfloat16, as Flax's ``dtype=bfloat16`` keeps float32 parameters.

:class:`BatchNorm` is Flax's ``nn.BatchNorm(use_running_average=not
train)``: at inference the running statistics (cast to the input's dtype);
in train mode float32 batch statistics over N, H and W (float64 for a
float64 input), the variance ``mean(x^2) - mean^2`` clamped at 0 as
Flax's default computes it, and the running averages moved by
``momentum`` in Flax's convention (new = momentum * running + (1 -
momentum) * batch), fed that biased variance.

:class:`Dropout` is Flax's ``nn.Dropout``: per channel
(``broadcast_dims=(1, 2)`` over NHWC, FusionNet's) or per element
(AdapNet's), drawing from an explicit ``torch.Generator``.

:func:`training_convolutions` turns cuDNN off for a float32 training step
on a card: with cuDNN's float32 convolutions (TF32 off) the gradients of
``chip_smoke.py`` phase 10's stream lay 0.371 (relative L2) from float64,
with PyTorch's own 0.0019, the CPU's f32 0.0016, while the forward and
each convolution alone stayed within 1e-6 (tools/training_precision.py;
neither BatchNorm's variance in two passes nor cuDNN's ``benchmark`` or
``deterministic`` moved it). bf16 training keeps cuDNN.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "ConvTranspose2d", "BatchNorm", "Dropout",
           "batch_variance", "set_dropout_generator",
           "training_convolutions"]


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv2d computing in its input's dtype (parameters cast to it)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d computing in its input's dtype."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


def batch_variance(xf: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The biased per-channel variance of NCHW ``xf`` about ``mean``:
    ``mean(x^2) - mean^2``, clamped at 0 (``maximum``, whose gradient
    splits at a tie, as jnp's does)."""
    return torch.maximum(xf.square().mean((0, 2, 3)) - mean.square(),
                         torch.zeros((), dtype=xf.dtype, device=xf.device))


def training_convolutions(dtype: torch.dtype, device):
    """The context a training step's forward and backward run in: cuDNN
    off for ``dtype`` float32 on a card, else no change."""
    if dtype == torch.float32 and torch.device(device).type == "cuda":
        return torch.backends.cudnn.flags(
            enabled=False, allow_tf32=torch.backends.cudnn.allow_tf32)
    return contextlib.nullcontext()


class BatchNorm(nn.BatchNorm2d):
    """Flax ``nn.BatchNorm`` (epsilon 1e-5) over NCHW; ``momentum`` in
    Flax's convention (FusionNet's 0.99, AdapNet's 0.9)."""

    def __init__(self, ch: int, momentum: float = 0.99):
        super().__init__(ch, eps=1e-5, momentum=1.0 - momentum)
        self.flax_momentum = float(momentum)

    def forward(self, x):
        if not self.training:
            dt = x.dtype
            return F.batch_norm(x, self.running_mean.to(dt),
                                self.running_var.to(dt), self.weight.to(dt),
                                self.bias.to(dt), False, 0.0, self.eps)
        xf = x.float() if x.dtype != torch.float64 else x
        mean = xf.mean((0, 2, 3))
        var = batch_variance(xf, mean)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Flax ``nn.Dropout(rate)``: in train mode one keep draw per (sample,
    channel) (``per_channel``, Flax's ``broadcast_dims=(1, 2)``) or per
    element, kept values scaled by 1 / (1 - rate). Draws from
    ``generator`` (never the global RNG); identity at inference and at
    rate 0."""

    def __init__(self, rate: float, per_channel: bool = True):
        super().__init__()
        self.rate = float(rate)
        self.per_channel = per_channel
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode needs a generator "
                               "(set_dropout_generator)")
        keep = 1.0 - self.rate
        shape = x.shape[:2] + (1, 1) if self.per_channel else x.shape
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


def set_dropout_generator(module: nn.Module, generator: torch.Generator):
    """The generator every :class:`Dropout` of ``module`` draws from in
    train mode."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
