"""The pieces every plain reference net is made of: convolutions, linear
layers and attention's two products that can run through a quantiser,
inference BatchNorm, and float32 without TF32 (``plain_precision``).

``set_quantiser`` hands one rounding function to every product of a net:
each convolution's and linear layer's input and weights, and both
operands of attention's QKᵀ and PV. That is how the bfloat16 probe and
the float8 control are built: the same nets with every product's operands
rounded to a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "ConvTranspose2d", "Linear", "Attention", "BatchNorm",
           "set_quantiser", "plain_precision"]


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


class Linear(nn.Linear):
    quantiser: Optional[Callable] = None

    def forward(self, x):
        w = self.weight
        if self.quantiser is not None:
            x, w = self.quantiser(x), self.quantiser(w)
        return F.linear(x, w, self.bias)


class Attention(nn.Module):
    """softmax(q kᵀ · scale) v over the last two dimensions (the key length
    may differ from the query length), the operands of both products
    through the quantiser."""

    quantiser: Optional[Callable] = None

    def forward(self, q, k, v, scale: float):
        if self.quantiser is not None:
            q, k = self.quantiser(q), self.quantiser(k)
        a = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * scale, -1)
        if self.quantiser is not None:
            a, v = self.quantiser(a), self.quantiser(v)
        return torch.matmul(a, v)


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm (running statistics), epsilon 1e-5."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def set_quantiser(module: nn.Module, fn: Optional[Callable]) -> nn.Module:
    """Run every product of ``module`` through ``fn`` (None: plain)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, Attention)):
            m.quantiser = fn
    return module
