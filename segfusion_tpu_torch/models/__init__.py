"""FusionNet v3 and AdapNet++ (PyTorch)."""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["seeded_init"]


@torch.no_grad()
def seeded_init(module: nn.Module, generator: torch.Generator
                ) -> nn.Module:
    """Random weights from ``generator``, distributed like Flax's defaults:
    conv kernels normal with variance 1 / fan_in (lecun), biases 0,
    BatchNorm identity (scale 1, bias 0, mean 0, var 1). Draws on the
    generator's device and copies into the module, in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else \
                w.shape[0] * w[0, 0].numel()
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device)
                    / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
