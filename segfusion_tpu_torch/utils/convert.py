"""Flax parameter trees -> the port's modules.

Counterpart of ``segfusion_tpu/utils/torch_convert.py``: the port's modules
carry the Flax auto-names, so a Flax tree maps onto them by name.
Conv kernels HWIO become OIHW; ConvTranspose kernels (kH, kW, in, out)
become (in, out, kH, kW) spatially flipped (Flax applies them unflipped,
torch flipped); BatchNorm scale/bias/mean/var become weight/bias/
running_mean/running_var. Every Flax leaf must be consumed and every
parameter and buffer of the module set, or loading raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.adapnet import build_adapnet
from ..models.fusionnet import build_fusion_net

__all__ = ["load_flax", "fusionnet_from_flax", "adapnet_from_flax"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _layer_tensors(layer: nn.Module, p, s):
    """(torch attribute, value) pairs for one Flax leaf layer."""
    if isinstance(layer, nn.ConvTranspose2d):
        k = np.asarray(p["kernel"])[::-1, ::-1]
        out = [("weight", np.transpose(k, (2, 3, 0, 1)))]
    elif isinstance(layer, nn.Conv2d):
        out = [("weight", np.transpose(np.asarray(p["kernel"]),
                                       (3, 2, 0, 1)))]
    elif isinstance(layer, nn.BatchNorm2d):
        return [("weight", p["scale"]), ("bias", p["bias"]),
                ("running_mean", s["mean"]), ("running_var", s["var"])]
    else:
        raise TypeError(f"no Flax mapping for {type(layer).__name__}")
    if "bias" in p:
        out.append(("bias", p["bias"]))
    return out


def load_flax(module: nn.Module, params, batch_stats) -> nn.Module:
    """Copy a Flax ``(params, batch_stats)`` pair (numpy-convertible
    leaves) into ``module`` by name; returns the module."""
    assigned, consumed = set(), set()

    def walk(mod: nn.Module, p, s, path):
        for name in p:
            child = getattr(mod, name, None)
            if not isinstance(child, nn.Module):
                raise KeyError("module has no submodule "
                               + ".".join(path + (name,)))
            sub_p, sub_s = p[name], s.get(name, {})
            if isinstance(child, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.BatchNorm2d)):
                for attr, value in _layer_tensors(child, sub_p, sub_s):
                    tgt = getattr(child, attr)
                    val = torch.as_tensor(np.ascontiguousarray(value),
                                          dtype=tgt.dtype)
                    if tuple(val.shape) != tuple(tgt.shape):
                        where = ".".join(path + (name, attr))
                        raise ValueError(
                            f"shape mismatch at {where}: "
                            f"{tuple(val.shape)} vs {tuple(tgt.shape)}")
                    with torch.no_grad():
                        tgt.copy_(val)
                    assigned.add(".".join(path + (name, attr)))
                consumed.update(("p",) + path + (name,) + leaf
                                for leaf in _leaves(sub_p))
                consumed.update(("s",) + path + (name,) + leaf
                                for leaf in _leaves(sub_s))
            else:
                walk(child, sub_p, sub_s, path + (name,))

    walk(module, params, batch_stats, ())
    left = ({("p",) + k for k in _leaves(params)}
            | {("s",) + k for k in _leaves(batch_stats)}) - consumed
    if left:
        raise ValueError(f"Flax leaves not consumed: {sorted(left)[:8]}")
    missing = [k for k in module.state_dict()
               if k not in assigned and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"module tensors not set: {missing[:8]}")
    return module


def fusionnet_from_flax(params, batch_stats, cfg) -> nn.Module:
    """FUSION_MODEL config + Flax FusionNet trees -> loaded FusionNetV3."""
    return load_flax(build_fusion_net(cfg), params, batch_stats)


def adapnet_from_flax(params, batch_stats, cfg) -> nn.Module:
    """SEMANTIC_2D_MODEL config + Flax AdapNet trees -> loaded AdapNet."""
    return load_flax(build_adapnet(cfg), params, batch_stats)
