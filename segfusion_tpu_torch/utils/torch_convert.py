"""Reference PyTorch checkpoints (``.pth.tar``) onto the port's modules.

Port of ``segfusion_tpu/utils/torch_convert.py``. Both sides are torch, so
tensors keep their layouts (OIHW convolution kernels, ConvTranspose
(in, out, kH, kW), BatchNorm weight / bias / running_mean / running_var):
what the conversion decides is which reference tensor goes where.

- FusionNet v1 / v2 / v3 (:func:`convert_fusionnet_state_dict`): by
  execution order with shape checks. The reference and the port apply
  their convolution and BatchNorm layers in the same sequence, so pairing
  the two ordered lists (conv with conv, BN with BN) maps them one to one.
  The port keeps v3's two heads as two modules, stacked-head configs too,
  so their order is the reference's.
- AdapNet++ (:func:`convert_adapnet_state_dict`): the reference encoder
  registers its skip convolutions before the backbone, so an explicit
  name map (:func:`adapnet_name_map`) names each reference layer's port
  module.
- The torchvision ResNet-50 import and the checkpoint reader live in
  ``utils/torch_import.py``.

Each returns the port module's ``state_dict`` and raises on a shape or
kind mismatch, a count mismatch or a module tensor left without a source:
no partial loads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..config import Config
from ..models.adapnet import build_adapnet
from ..models.fusionnet import build_fusion_net
from .torch_import import convert_resnet50_encoder, load_torch_checkpoint

__all__ = ["load_torch_checkpoint", "convert_fusionnet_state_dict",
           "adapnet_name_map", "convert_adapnet_state_dict",
           "convert_resnet50_encoder"]

_BN = ("weight", "bias", "running_mean", "running_var")


def _fusionnet_module_order(model_cfg) -> List[str]:
    """The port's FusionNet module paths in execution order (the
    reference's construction and state-dict order)."""
    name = model_cfg.get("name", "v3")
    if name == "v1":
        return [f"Block_{i}" for i in range(4)] + \
            [f"Pred_{i}" for i in range(4)]
    g = int(model_cfg.get("growth_factor", 6)) - 1
    preds = [f"Pred_{i}" for i in range(g)]
    if name == "v2":
        return [f"Block_{i}" for i in range(g)] + \
            ["VortexPooling_0", "VortexPooling_1"] + preds
    heads = (["head_tsdf", "head_sem"]
             if bool(model_cfg.get("use_semantics", False))
             else ["FusionHead_0"])
    order = []
    for h in heads:
        order += [f"{h}.Block_{i}" for i in range(g)]
        order.append(f"{h}.VortexPooling_0")
    return order + ["VortexPooling_0"] + preds


def _layer_index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _ordered_port_layers(net: nn.Module, model_cfg):
    """(path, kind, layer) of the net's convolutions and BatchNorms in
    execution order: by module in :func:`_fusionnet_module_order`, within
    one Conv_k then BatchNorm_k for ascending k."""
    layers = []
    for prefix in _fusionnet_module_order(model_cfg):
        mod = net.get_submodule(prefix)
        own = []
        for child_name, child in mod.named_children():
            if isinstance(child, nn.Conv2d):
                own.append(((_layer_index(child_name), 0), child_name,
                            "conv", child))
            elif isinstance(child, nn.BatchNorm2d):
                own.append(((_layer_index(child_name), 1), child_name,
                            "bn", child))
        layers += [(f"{prefix}.{n}", kind, layer)
                   for _, n, kind, layer in sorted(own, key=lambda t: t[0])]
    return layers


def _ordered_reference_layers(state: Dict[str, torch.Tensor]):
    """The reference state dict's layers as (module name, kind, tensors)
    in registration order; kind "conv" (a 4-D weight) or "bn" (running
    statistics), other entries dropped."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        mod, leaf = key.rsplit(".", 1)
        groups.setdefault(mod, {})[leaf] = val
    layers = []
    for mod, g in groups.items():
        if "running_mean" in g:
            layers.append((mod, "bn", g))
        elif "weight" in g and g["weight"].dim() == 4:
            layers.append((mod, "conv", g))
    return layers


def _put(out: Dict[str, torch.Tensor], key: str, value: torch.Tensor,
         like: torch.Tensor):
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch at {key}: {tuple(like.shape)} vs "
                         f"{tuple(value.shape)}")
    out[key] = value.detach().to(like.dtype).clone()


def convert_fusionnet_state_dict(torch_state: Dict[str, torch.Tensor],
                                 model_cfg) -> Dict[str, torch.Tensor]:
    """A reference FusionNet state dict -> the ``state_dict`` of the port's
    net built from ``model_cfg`` (the FUSION_MODEL section: it fixes the
    execution order). Raises on a layer count, kind or shape mismatch."""
    net = build_fusion_net(model_cfg)
    ours = _ordered_port_layers(net, model_cfg)
    theirs = _ordered_reference_layers(torch_state)
    if len(ours) != len(theirs):
        raise ValueError(
            f"layer count mismatch: the port's net has {len(ours)}, the "
            f"checkpoint {len(theirs)} -- are the model config's n_points, "
            "growth_factor and use_semantics the checkpoint's?")
    out = dict(net.state_dict())
    for (path, kind, layer), (tname, tkind, tensors) in zip(ours, theirs):
        if kind != tkind:
            raise ValueError(f"layer kind mismatch: {path} ({kind}) vs "
                             f"{tname} ({tkind})")
        attrs = ("weight", "bias") if kind == "conv" else _BN
        for attr in attrs:
            like = getattr(layer, attr)
            if like is None:
                continue
            if attr not in tensors:
                raise KeyError(f"checkpoint layer {tname} has no {attr}")
            _put(out, f"{path}.{attr}", tensors[attr], like)
    return out


# -- AdapNet++ ----------------------------------------------------------------

def _encoder_name_map(prefix: str) -> Dict[str, Tuple[str, str]]:
    m = {}

    def unit(t, f, names):
        for tv, port, kind in names:
            m[f"{t}.{tv}"] = (f"{f}.{port}", kind)

    bottleneck = (("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
                  ("conv2", "Conv_1", "conv"), ("bn2", "BatchNorm_1", "bn"),
                  ("conv3", "Conv_2", "conv"), ("bn3", "BatchNorm_2", "bn"),
                  ("downsample.0", "downsample_conv", "conv"),
                  ("downsample.1", "BatchNorm_3", "bn"))
    ssma = (("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
            ("conv2a", "Conv_1", "conv"), ("bn2a", "BatchNorm_1", "bn"),
            ("conv2b", "Conv_2", "conv"), ("bn2b", "BatchNorm_2", "bn"),
            ("conv3", "Conv_3", "conv"), ("bn3", "BatchNorm_3", "bn"),
            ("downsample.0", "downsample_conv", "conv"),
            ("downsample.1", "BatchNorm_4", "bn"))
    r = f"{prefix}.res_n50_enc"
    m[f"{r}.conv1"] = (f"{prefix}.Conv_0", "conv")
    m[f"{r}.bn1"] = (f"{prefix}.BatchNorm_0", "bn")
    m[f"{prefix}.enc_skip2_conv"] = (f"{prefix}.Conv_1", "conv")
    m[f"{prefix}.enc_skip2_conv_bn"] = (f"{prefix}.BatchNorm_1", "bn")
    m[f"{prefix}.enc_skip1_conv"] = (f"{prefix}.Conv_2", "conv")
    m[f"{prefix}.enc_skip1_conv_bn"] = (f"{prefix}.BatchNorm_2", "bn")
    for i in range(3):
        unit(f"{r}.layer1.{i}", f"{prefix}.Bottleneck_{i}", bottleneck)
        unit(f"{r}.layer2.{i}", f"{prefix}.Bottleneck_{3 + i}", bottleneck)
    unit(f"{r}.layer2.3", f"{prefix}.BottleneckSSMA_0", ssma)
    for i in range(2):
        unit(f"{r}.layer3.{i}", f"{prefix}.Bottleneck_{6 + i}", bottleneck)
    for i in range(4):
        unit(f"{r}.layer3.{2 + i}", f"{prefix}.BottleneckSSMA_{1 + i}", ssma)
    for i in range(3):
        unit(f"{r}.layer4.{i}", f"{prefix}.BottleneckSSMA_{5 + i}", ssma)
    return m


def _easpp_name_map(t: str, f: str) -> Dict[str, Tuple[str, str]]:
    m = {f"{t}.branch1_conv": (f"{f}.Conv_0", "conv"),
         f"{t}.branch1_bn": (f"{f}.BatchNorm_0", "bn")}
    for b in range(3):
        seq = f"{t}.branch234.{b}"
        for tidx, fidx in zip((0, 3, 6, 9), range(1 + 4 * b, 5 + 4 * b)):
            m[f"{seq}.{tidx}"] = (f"{f}.Conv_{fidx}", "conv")
            m[f"{seq}.{tidx + 1}"] = (f"{f}.BatchNorm_{fidx}", "bn")
    m[f"{t}.branch5_conv"] = (f"{f}.Conv_13", "conv")
    # branch5_bn is registered but unused in the reference forward
    m[f"{t}.eASPP_fin_conv"] = (f"{f}.Conv_14", "conv")
    m[f"{t}.eASPP_fin_bn"] = (f"{f}.BatchNorm_13", "bn")
    return m


def _decoder_name_map() -> Dict[str, Tuple[str, str]]:
    d = "decoder"
    pairs = [("deconv1", "ConvTranspose_0"), ("deconv1_bn", "BatchNorm_0"),
             ("aux_conv1", "Conv_0"), ("aux_conv1_bn", "BatchNorm_1"),
             ("fuse_conv1", "fuse_conv1"),
             ("stage2.0", "Conv_1"), ("stage2.1", "BatchNorm_2"),
             ("stage2.3", "Conv_2"), ("stage2.4", "BatchNorm_3"),
             ("stage2.6", "ConvTranspose_1"), ("stage2.7", "BatchNorm_4"),
             ("aux_conv2", "Conv_3"), ("aux_conv2_bn", "BatchNorm_5"),
             ("fuse_conv2", "fuse_conv2"),
             ("stage3.0", "Conv_4"), ("stage3.1", "BatchNorm_6"),
             ("stage3.3", "Conv_5"), ("stage3.4", "BatchNorm_7"),
             ("stage3.6", "Conv_6"), ("stage3.7", "BatchNorm_8"),
             ("stage3.8", "ConvTranspose_2"), ("stage3.9", "BatchNorm_9")]
    return {f"{d}.{t}": (f"{d}.{p}", "bn" if p.startswith("BatchNorm")
                         else "conv") for t, p in pairs}


def _ssma_name_map(t: str, f: str) -> Dict[str, Tuple[str, str]]:
    return {f"{t}.link.0": (f"{f}.Conv_0", "conv"),
            f"{t}.link.2": (f"{f}.Conv_1", "conv"),
            f"{t}.final_conv.0": (f"{f}.Conv_2", "conv"),
            f"{t}.final_conv.1": (f"{f}.BatchNorm_0", "bn")}


def adapnet_name_map(stage: int) -> Dict[str, Tuple[str, str]]:
    """Reference module name -> (the port's module path, "conv" or "bn")
    for AdapNet++ ``stage`` 1 or 2 (the reference's
    ``modules/adapnet.py:356-384`` construction)."""
    m = dict(_encoder_name_map("encoder_mod1"))
    if stage == 1:
        m.update(_easpp_name_map("eASPP", "eASPP"))
    else:
        m.update(_encoder_name_map("encoder_mod2"))
        for name in ("eASPP_mod1", "eASPP_mod2"):
            m.update(_easpp_name_map(name, name))
        for name in ("ssma_res", "ssma_s1", "ssma_s2"):
            m.update(_ssma_name_map(name, name))
    m.update(_decoder_name_map())
    return m


def convert_adapnet_state_dict(torch_state: Dict[str, torch.Tensor],
                               stage: int, n_classes: int = 30
                               ) -> Dict[str, torch.Tensor]:
    """A reference AdapNet++ state dict -> the ``state_dict`` of the port's
    stage-``stage`` AdapNet with ``n_classes`` classes. Reference entries
    the port has no place for (``branch5_bn``, ``num_batches_tracked``)
    are dropped; a port tensor without a reference source raises."""
    net = build_adapnet(Config({"n_classes": int(n_classes),
                                "stage": int(stage)}))
    out = dict(net.state_dict())
    assigned = set()
    for tname, (path, kind) in adapnet_name_map(stage).items():
        if f"{tname}.weight" not in torch_state:
            continue     # the downsample of a block that has none
        try:
            layer = net.get_submodule(path)
        except AttributeError:
            continue     # a block of the map the port's net lacks
        for attr in (("weight", "bias") if kind == "conv" else _BN):
            like = getattr(layer, attr, None)
            src = torch_state.get(f"{tname}.{attr}")
            if like is None or src is None:
                continue
            _put(out, f"{path}.{attr}", src, like)
            assigned.add(f"{path}.{attr}")
    missing = [k for k in out if k not in assigned
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"module tensors without a checkpoint source: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out

