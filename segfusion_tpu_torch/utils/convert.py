"""Flax parameter trees <-> the port's modules.

Counterpart of ``segfusion_tpu/utils/torch_convert.py``: the port's modules
carry the Flax auto-names, so a Flax tree maps onto them by name, and
:func:`to_flax` writes a module back as Flax trees.
Conv kernels HWIO become OIHW; ConvTranspose kernels (kH, kW, in, out)
become (in, out, kH, kW) spatially flipped (Flax applies them unflipped,
torch flipped); BatchNorm scale/bias/mean/var become weight/bias/
running_mean/running_var. Every Flax leaf must be consumed and every
parameter and buffer of the module set, or loading raises. The inverse
(:func:`to_flax`, :func:`flax_tree`, :func:`from_flax_tree`) undoes each
of these, so a module's parameters and any per-parameter tensors (grads,
optimizer moments) carry across both ways.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.adapnet import SegmenterAdapter, build_adapnet
from ..models.fusionnet import build_fusion_net

__all__ = ["load_flax", "fusionnet_from_flax", "adapnet_from_flax",
           "fusionnet_from_checkpoint", "adapnet_from_checkpoint",
           "segmenter_from_checkpoint",
           "to_flax", "flax_tree", "from_flax_tree"]


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


def fusionnet_from_checkpoint(path: str, cfg) -> nn.Module:
    """FUSION_MODEL config + a fusion checkpoint (either package's) ->
    loaded FusionNetV3: its ``params`` with a ``_fusion_network`` prefix
    stripped (the reference's pipeline checkpoints carry one) and its
    ``batch_stats``, the module's initial statistics where it has none
    (as the JAX package's ``test_fusion`` loads it)."""
    from .checkpoints import load_checkpoint, remove_parent
    ck = load_checkpoint(path)
    net = build_fusion_net(cfg)
    params = remove_parent(ck.get("params", ck), "_fusion_network")
    return load_flax(net, params, ck.get("batch_stats") or to_flax(net)[1])


def adapnet_from_checkpoint(path: str, cfg) -> nn.Module:
    """SEMANTIC_2D_MODEL config + a segmentation checkpoint -> AdapNet."""
    from .checkpoints import load_checkpoint
    ck = load_checkpoint(path)
    return adapnet_from_flax(ck["params"], ck.get("batch_stats", {}), cfg)


def segmenter_from_checkpoint(path: str, cfg, input_mode: str,
                              device) -> SegmenterAdapter:
    """The pipelines' segmenter: the AdapNet of a segmentation checkpoint
    (either stage), cast to its compute dtype on ``device`` for
    inference, stage 1 fed the ``input_mode`` modality (DATA.input)."""
    model = adapnet_from_checkpoint(path, cfg)
    dtype = model.compute_dtype or torch.float32
    return SegmenterAdapter(model.to(device, dtype).eval(), input_mode)


# -- the module -> Flax direction ---------------------------------------------

_BN_NAMES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var")}


def _flax_slots(module: nn.Module):
    """torch state name -> (collection, Flax path, layer) for every tensor
    the Flax trees hold (``num_batches_tracked`` has no Flax leaf)."""
    slots = {}
    for mod_name, layer in module.named_modules():
        path = tuple(mod_name.split(".")) if mod_name else ()
        if isinstance(layer, nn.BatchNorm2d):
            for attr, (col, leaf) in _BN_NAMES.items():
                slots[f"{mod_name}.{attr}"] = (col, path + (leaf,), layer)
        elif isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
            slots[f"{mod_name}.weight"] = ("params", path + ("kernel",),
                                           layer)
            if layer.bias is not None:
                slots[f"{mod_name}.bias"] = ("params", path + ("bias",),
                                             layer)
    return slots


def _to_flax_layout(layer, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if isinstance(layer, nn.ConvTranspose2d):
        return np.ascontiguousarray(
            np.transpose(value, (2, 3, 0, 1))[::-1, ::-1])
    return np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))


def _from_flax_layout(layer, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return np.asarray(value)
    if isinstance(layer, nn.ConvTranspose2d):
        return np.transpose(np.asarray(value)[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(np.asarray(value), (3, 2, 0, 1))


def _host(t) -> np.ndarray:
    return (t.detach().float().cpu().numpy() if t.is_floating_point()
            else t.detach().cpu().numpy())


def flax_tree(module: nn.Module, tensors: Mapping[str, torch.Tensor],
              collection: str = "params") -> dict:
    """Per-tensor values keyed by the module's state names (its
    parameters, or tensors shaped like them: grads, optimizer moments)
    as the Flax ``collection`` tree, in Flax layout, float32 numpy."""
    tree: dict = {}
    for name, (col, path, layer) in _flax_slots(module).items():
        if col != collection:
            continue
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = _to_flax_layout(layer, path[-1], _host(tensors[name]))
    return tree


def from_flax_tree(module: nn.Module, tree: Mapping,
                   collection: str = "params") -> dict:
    """The inverse of :func:`flax_tree`: state name -> numpy value in the
    module's layout (shape-checked against the module)."""
    state = module.state_dict()
    out = {}
    for name, (col, path, layer) in _flax_slots(module).items():
        if col != collection:
            continue
        d = tree
        for k in path:
            if k not in d:
                raise KeyError("Flax tree has no leaf " + "/".join(path))
            d = d[k]
        value = _from_flax_layout(layer, path[-1], d)
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"shape mismatch at {name}: "
                             f"{tuple(value.shape)} vs "
                             f"{tuple(state[name].shape)}")
        out[name] = value
    return out


def to_flax(module: nn.Module):
    """The module as Flax ``(params, batch_stats)`` numpy trees, kernels
    HWIO: the inverse of :func:`load_flax`."""
    state = module.state_dict()
    return (flax_tree(module, state, "params"),
            flax_tree(module, state, "batch_stats"))
