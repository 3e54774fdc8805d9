"""Random weights for a cell's nets, made on the device from the seed.

Distributed as the port's ``models.seeded_init`` describes Flax's
defaults: convolution and linear kernels normal with variance 1 / fan_in,
biases 0, BatchNorm the identity (scale 1, bias 0, mean 0, variance 1),
LayerNorm and GroupNorm scale 1 and bias 0. All kernels of a net come from
one ``torch.randn`` call on the device, the convolutions' first and the
linear layers' after them, and are cut into the net's tensors; the state
dict they form loads into the port's module and into the reference's copy
alike, since both keep the same names. A parameter of any other kind of
module has no rule and raises.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

__all__ = ["random_state", "generator"]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + int(stream)) % (1 << 63))
    return g


_KERNELS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm,
          nn.GroupNorm)


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    return (w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose2d)
            else w[0].numel())


def random_state(module: nn.Module, gen: torch.Generator, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (built on any device, the meta device
    included) with random kernels in ``dtype`` on ``device``."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in
              module.state_dict(keep_vars=True).items()}
    convs, linears, ones = [], [], set()
    for name, m in module.named_modules():
        for pname, p in m.named_parameters(prefix=name, recurse=False):
            leaf = pname.rsplit(".", 1)[-1]
            if leaf == "weight" and isinstance(m, _KERNELS):
                (linears if isinstance(m, nn.Linear) else convs).append(
                    (pname, tuple(p.shape), _fan_in(m)))
            elif leaf == "weight" and isinstance(m, _NORMS):
                ones.add(pname)
            elif leaf != "bias" or not isinstance(m, _KERNELS + _NORMS):
                raise ValueError(f"random_state: no rule for {pname} of a "
                                 f"{type(m).__name__}")
    kernels = convs + linears
    total = sum(math.prod(s) for _, s, _ in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape, fan_in in kernels:
        n = math.prod(shape)
        state[key] = (flat[at:at + n].view(shape) / math.sqrt(fan_in)).to(
            dtype)
        at += n
    for key, (shape, dt) in shapes.items():
        if key in state:
            continue
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros(shape, dtype=torch.long, device=device)
        elif key in ones or key.endswith("running_var"):
            state[key] = torch.ones(shape, dtype=dtype, device=device)
        else:       # biases, running means
            state[key] = torch.zeros(shape, dtype=dtype, device=device)
    return {k: state[k] for k in shapes}
