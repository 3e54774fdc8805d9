"""torchvision ResNet-50 weights onto the port's AdapNet++ encoders.

Counterpart of ``load_torch_checkpoint``, ``_resnet50_surviving_map`` and
``convert_resnet50_encoder`` of ``segfusion_tpu/utils/torch_convert.py``:
the ImageNet initialisation of the reference's segmentation training
(``resnet50(pretrained=True)`` before its encoder surgery). Only the
weights that survive the surgery are written:

- layer1.[0-2], layer2.[0-2] and layer3.[0-1], intact bottlenecks;
- conv1 / bn1 of the units the surgery replaces by multi-dilation units
  (layer2.3, layer3.[2-5], layer4.[0-2]);
- layer4.0's projection, its stride forced to 1 (a 1x1 kernel: the
  weights are unchanged).

The stem, the skip convolutions, the dilated branches of replaced units
and the fc head keep their fresh initialisation, as in the reference. The
port's modules carry torchvision's own layouts (OIHW kernels, BatchNorm
weight / bias / running_mean / running_var), so each tensor copies over
unchanged. Reading a checkpoint needs torch alone (no torchvision).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

__all__ = ["load_torch_checkpoint", "resnet50_surviving_map",
           "convert_resnet50_encoder"]


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's ``model_state`` (or the whole file, where it
    is a state dict) as CPU tensors; ``weights_only`` loading, so the file
    runs no code."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state = ck.get("model_state", ck)
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def resnet50_surviving_map(prefix: str) -> Dict[str, Tuple[str, str]]:
    """torchvision name -> (the port's module path under ``prefix``,
    "conv" or "bn") for the layers that survive the surgery."""
    m = {}

    def bottleneck(t, f):
        for tv, port, kind in (("conv1", "Conv_0", "conv"),
                               ("bn1", "BatchNorm_0", "bn"),
                               ("conv2", "Conv_1", "conv"),
                               ("bn2", "BatchNorm_1", "bn"),
                               ("conv3", "Conv_2", "conv"),
                               ("bn3", "BatchNorm_2", "bn"),
                               ("downsample.0", "downsample_conv", "conv"),
                               ("downsample.1", "BatchNorm_3", "bn")):
            m[f"{t}.{tv}"] = (f"{f}.{port}", kind)

    def head(t, f):
        m[f"{t}.conv1"] = (f"{f}.Conv_0", "conv")
        m[f"{t}.bn1"] = (f"{f}.BatchNorm_0", "bn")

    for i in range(3):
        bottleneck(f"layer1.{i}", f"{prefix}.Bottleneck_{i}")
        bottleneck(f"layer2.{i}", f"{prefix}.Bottleneck_{3 + i}")
    head("layer2.3", f"{prefix}.BottleneckSSMA_0")
    for i in range(2):
        bottleneck(f"layer3.{i}", f"{prefix}.Bottleneck_{6 + i}")
    for i in range(4):
        head(f"layer3.{2 + i}", f"{prefix}.BottleneckSSMA_{1 + i}")
    for i in range(3):
        head(f"layer4.{i}", f"{prefix}.BottleneckSSMA_{5 + i}")
    m["layer4.0.downsample.0"] = (f"{prefix}.BottleneckSSMA_5."
                                  "downsample_conv", "conv")
    m["layer4.0.downsample.1"] = (f"{prefix}.BottleneckSSMA_5.BatchNorm_4",
                                  "bn")
    return m


_BN = ("weight", "bias", "running_mean", "running_var")


@torch.no_grad()
def convert_resnet50_encoder(tv_state: Dict[str, torch.Tensor],
                             model: nn.Module,
                             encoders=("encoder_mod1",)) -> int:
    """Copy a torchvision resnet50 ``state_dict`` into the encoder(s) of
    an AdapNet ``model``, in place. Returns the number of tensors written
    (a convolution 1, a BatchNorm 4); raises on a shape mismatch, a
    missing encoder or a state dict without resnet50's names."""
    n = 0
    for enc in encoders:
        if not isinstance(getattr(model, enc, None), nn.Module):
            raise KeyError(f"no encoder submodule {enc!r} in the model")
        for tname, (path, kind) in resnet50_surviving_map(enc).items():
            if f"{tname}.weight" not in tv_state:
                if ".downsample." in tname:
                    continue   # only the first block of a stage projects
                raise KeyError(f"torchvision state_dict missing "
                               f"{tname}.weight -- is this a resnet50 "
                               "checkpoint?")
            layer = model.get_submodule(path)
            for attr in (("weight",) if kind == "conv" else _BN):
                dst = getattr(layer, attr)
                src = tv_state[f"{tname}.{attr}"]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"shape mismatch at {path}.{attr}: "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.to(dst.dtype))
                n += 1
    return n
