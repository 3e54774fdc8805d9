"""AdapNet++ semantic segmentation, stages 1 and 2.

Port of ``segfusion_tpu/models/adapnet.py``: the multi-dilation ResNet-50
encoder (built by hand), eASPP, SSMA fusion and the 3-stage decoder with
its two auxiliary heads. Stage 1 segments one modality (``encoder_mod1``
-> ``eASPP`` -> decoder with plain skips); stage 2 fuses an RGB and a
depth encoder by SSMA at the bottleneck and both skips, the decoder
gating each skip by the global context of its features.

Submodules carry the Flax auto-names so ``utils/convert.py`` loads a Flax
tree by name. Flax's ``ConvTranspose(padding="SAME")`` applies its kernel
unflipped; here it is a transposed convolution with ``padding=(k - s) //
2`` and the converter flips the kernel. The layers are those of
``models/layers.py`` (BatchNorm with Flax's momentum 0.9 here, per-element
dropout), so the net trains as the Flax module does: f32 master weights
computing in ``compute_dtype`` (bf16 for the configured runs), f32
BatchNorm statistics, the layer3[2] dropout drawn from the generator
given to :meth:`AdapNet.set_dropout_generator`. ``forward`` returns
``[res, aux1, aux2]`` in f32, the aux heads upsampled bilinearly with
half-pixel centres (``jax.image.resize``'s "bilinear");
:meth:`AdapNet.logits` computes ``res`` alone. :class:`SegmenterAdapter`
replays its inference forward from a CUDA graph per input signature on
the card (its docstring says when); the kernels, and so the numbers, are
the eager forward's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..utils import tracing
from .cuda_graphs import SignatureGraphs, _capture, _on_card
from .layers import (BatchNorm, Conv2d, ConvTranspose2d, Dropout,
                     set_dropout_generator)

__all__ = ["Bottleneck", "BottleneckSSMA", "Encoder", "EASPP", "Decoder",
           "SSMA", "AdapNet", "build_adapnet", "SegmenterAdapter"]

_BN_MOMENTUM = 0.9   # the JAX package's _bn: Flax momentum 0.9


def _bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, momentum=_BN_MOMENTUM)


def _conv(ci, co, k, stride=1, dil=1, bias=True):
    pad = dil * (k - 1) // 2
    return Conv2d(ci, co, k, stride=stride, padding=pad, dilation=dil,
                  bias=bias)


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` by an integer ``factor``
    over NCHW: half-pixel centres, the edge rows taking the border value
    (JAX renormalises the in-range weights, torch clamps the source
    index: the same numbers)."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * factor, w * factor), mode="bilinear",
                         align_corners=False)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck (1x1 -> 3x3 -> 1x1, x4 expansion)."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        out = 4 * mid
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = _bn(mid)
        self.Conv_1 = _conv(mid, mid, 3, stride=stride, bias=False)
        self.BatchNorm_1 = _bn(mid)
        self.Conv_2 = _conv(mid, out, 1, bias=False)
        self.BatchNorm_2 = _bn(out)
        self.has_down = project or stride != 1 or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, stride=stride,
                                         bias=False)
            self.BatchNorm_3 = _bn(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        res = (self.BatchNorm_3(self.downsample_conv(x)) if self.has_down
               else x)
        return F.relu(y + res)


class BottleneckSSMA(nn.Module):
    """Multi-dilation unit: 1x1 -> two parallel dilated 3x3 branches
    (r1, r2) of d3/2 channels each -> concat -> 1x1 to ``out``, then
    (``drop_out``) per-element dropout."""

    def __init__(self, in_ch: int, mid: int, r1: int, r2: int, d3: int,
                 out: int, project: bool = False, drop_out: bool = False,
                 drop_rate: float = 0.5):
        super().__init__()
        half = d3 // 2
        self.Conv_0 = _conv(in_ch, mid, 1, bias=False)
        self.BatchNorm_0 = _bn(mid)
        self.Conv_1 = _conv(mid, half, 3, dil=r1, bias=False)
        self.BatchNorm_1 = _bn(half)
        self.Conv_2 = _conv(mid, half, 3, dil=r2, bias=False)
        self.BatchNorm_2 = _bn(half)
        self.Conv_3 = _conv(d3, out, 1, bias=False)
        self.BatchNorm_3 = _bn(out)
        self.has_down = project or in_ch != out
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out, 1, bias=False)
            self.BatchNorm_4 = _bn(out)
        self.drop = (Dropout(drop_rate, per_channel=False) if drop_out
                     else nn.Identity())

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        a = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        b = F.relu(self.BatchNorm_2(self.Conv_2(y)))
        y = self.BatchNorm_3(self.Conv_3(torch.cat([a, b], 1)))
        res = (self.BatchNorm_4(self.downsample_conv(x)) if self.has_down
               else x)
        return self.drop(F.relu(y + res))


class Encoder(nn.Module):
    """ResNet-50 with the AdapNet++ surgery, output stride 16. Returns
    (features 2048ch @ /16, skip2 24ch @ /4, skip1 24ch @ /8)."""

    def __init__(self, resn50_dropout: bool = True):
        super().__init__()
        self.Conv_0 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = _bn(64)
        blocks = [(64, 64, 1, True), (256, 64, 1, False),
                  (256, 64, 1, False), (256, 128, 2, False),
                  (512, 128, 1, False), (512, 128, 1, False),
                  (512, 256, 2, False), (1024, 256, 1, False)]
        for i, (ci, mid, stride, proj) in enumerate(blocks):
            self.add_module(f"Bottleneck_{i}",
                            Bottleneck(ci, mid, stride, proj))
        ssma = [(512, 128, 1, 2, 64, 512, False, False)]
        ssma += [(1024, 256, 1, r2, 256, 1024, False,
                  i == 0 and resn50_dropout)
                 for i, r2 in enumerate((2, 16, 8, 4))]
        ssma += [(1024, 512, 2, 4, 512, 2048, True, False),
                 (2048, 512, 2, 8, 512, 2048, False, False),
                 (2048, 512, 2, 16, 512, 2048, False, False)]
        for i, (ci, mid, r1, r2, d3, out, proj, drop) in enumerate(ssma):
            self.add_module(f"BottleneckSSMA_{i}", BottleneckSSMA(
                ci, mid, r1, r2, d3, out, project=proj, drop_out=drop))
        self.Conv_1 = Conv2d(256, 24, 1)
        self.BatchNorm_1 = _bn(24)
        self.Conv_2 = Conv2d(512, 24, 1)
        self.BatchNorm_2 = _bn(24)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(3):                                  # layer1
            x = getattr(self, f"Bottleneck_{i}")(x)
        skip2 = self.BatchNorm_1(self.Conv_1(x))
        for i in range(3, 6):                               # layer2
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = self.BottleneckSSMA_0(x)
        skip1 = self.BatchNorm_2(self.Conv_2(x))
        for i in range(6, 8):                               # layer3
            x = getattr(self, f"Bottleneck_{i}")(x)
        for i in range(1, 8):                               # layer3/4
            x = getattr(self, f"BottleneckSSMA_{i}")(x)
        return x, skip2, skip1


class EASPP(nn.Module):
    """Efficient ASPP: 1x1 branch, 3 cascaded atrous branches (rates
    3/6/12), image pooling (no BN), concat + 1x1."""

    def __init__(self, in_ch: int = 2048, mid: int = 64, out: int = 256,
                 rates: Sequence[int] = (3, 6, 12)):
        super().__init__()
        self.rates = tuple(rates)
        self.Conv_0 = Conv2d(in_ch, out, 1)
        self.BatchNorm_0 = _bn(out)
        for r_i, r in enumerate(self.rates):
            k = 1 + 4 * r_i
            specs = [(in_ch, mid, 1, 1), (mid, mid, 3, r), (mid, mid, 3, r),
                     (mid, out, 1, 1)]
            for j, (ci, co, ks, dil) in enumerate(specs):
                self.add_module(f"Conv_{k + j}", _conv(ci, co, ks, dil=dil))
                self.add_module(f"BatchNorm_{k + j}", _bn(co))
        n = 1 + 4 * len(self.rates)
        self.add_module(f"Conv_{n}", Conv2d(in_ch, out, 1))  # pooling
        self.add_module(f"Conv_{n + 1}",
                        Conv2d(out * (2 + len(self.rates)), out, 1))
        self.add_module(f"BatchNorm_{n}", _bn(out))

    def forward(self, x):
        h, w = x.shape[-2:]
        branches = [F.relu(self.BatchNorm_0(self.Conv_0(x)))]
        for r_i in range(len(self.rates)):
            y = x
            for j in range(4):
                i = 1 + 4 * r_i + j
                y = F.relu(getattr(self, f"BatchNorm_{i}")(
                    getattr(self, f"Conv_{i}")(y)))
            branches.append(y)
        n = 1 + 4 * len(self.rates)
        g = F.relu(getattr(self, f"Conv_{n}")(x.mean((2, 3), keepdim=True)))
        branches.append(g.expand(-1, -1, h, w))
        y = getattr(self, f"Conv_{n + 1}")(torch.cat(branches, 1))
        return F.relu(getattr(self, f"BatchNorm_{n}")(y))


class Decoder(nn.Module):
    """3-stage decoder with two skips and two aux heads (1x1 conv + BN,
    upsampled x8 and x4). ``fusion`` (stage 2) gates each skip by the
    global context of the decoder features (``fuse_conv1/2``)."""

    def __init__(self, n_classes: int, fusion: bool = False):
        super().__init__()
        self.fusion = fusion
        self.ConvTranspose_0 = ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_0 = _bn(256)
        self.Conv_0 = Conv2d(256, n_classes, 1)           # aux head 1
        self.BatchNorm_1 = _bn(n_classes)
        if fusion:
            self.fuse_conv1 = Conv2d(256, 24, 1)
            self.fuse_conv2 = Conv2d(256, 24, 1)
        self.Conv_1 = _conv(280, 256, 3)
        self.BatchNorm_2 = _bn(256)
        self.Conv_2 = _conv(256, 256, 3)
        self.BatchNorm_3 = _bn(256)
        self.ConvTranspose_1 = ConvTranspose2d(256, 256, 4, 2, 1)
        self.BatchNorm_4 = _bn(256)
        self.Conv_3 = Conv2d(256, n_classes, 1)           # aux head 2
        self.BatchNorm_5 = _bn(n_classes)
        self.Conv_4 = _conv(280, 256, 3)
        self.BatchNorm_6 = _bn(256)
        self.Conv_5 = _conv(256, 256, 3)
        self.BatchNorm_7 = _bn(256)
        self.Conv_6 = Conv2d(256, n_classes, 1)
        self.BatchNorm_8 = _bn(n_classes)
        self.ConvTranspose_2 = ConvTranspose2d(n_classes, n_classes, 8, 4, 2)
        self.BatchNorm_9 = _bn(n_classes)

    def _skip(self, x, skip, gate: Optional[nn.Module]):
        skip = skip.to(x.dtype)
        if gate is None:
            return torch.cat([x, skip], 1)
        g = F.relu(gate(x.mean((2, 3), keepdim=True)))
        return torch.cat([x, g * skip], 1)

    def forward(self, x, skip1, skip2, aux: bool = True) -> List[torch.Tensor]:
        x = F.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))
        heads = []
        if aux:
            heads.append(upsample(self.BatchNorm_1(self.Conv_0(x)), 8))
        x = self._skip(x, skip1, self.fuse_conv1 if self.fusion else None)
        x = F.relu(self.BatchNorm_2(self.Conv_1(x)))
        x = F.relu(self.BatchNorm_3(self.Conv_2(x)))
        x = self.BatchNorm_4(self.ConvTranspose_1(x))
        if aux:
            heads.append(upsample(self.BatchNorm_5(self.Conv_3(x)), 4))
        x = self._skip(x, skip2, self.fuse_conv2 if self.fusion else None)
        x = F.relu(self.BatchNorm_6(self.Conv_4(x)))
        x = F.relu(self.BatchNorm_7(self.Conv_5(x)))
        x = self.BatchNorm_8(self.Conv_6(x))
        res = self.BatchNorm_9(self.ConvTranspose_2(x))
        return [t.float() for t in [res] + heads]


class SSMA(nn.Module):
    """Self-supervised modality attention fusion of two feature maps."""

    def __init__(self, features: int, bottleneck: int):
        super().__init__()
        reduce = features // bottleneck
        self.Conv_0 = _conv(2 * features, reduce, 3)
        self.Conv_1 = _conv(reduce, 2 * features, 3)
        self.Conv_2 = _conv(2 * features, features, 3)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x1, x2):
        x12 = torch.cat([x1, x2], 1)
        g = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(x12))))
        return self.BatchNorm_0(self.Conv_2(x12 * g))


class AdapNet(nn.Module):
    """Stage 1: one encoder, eASPP, the decoder with plain skips. Stage 2:
    RGB (``mod1``) and depth (``mod2``) encoders fused by SSMA at the
    bottleneck and both skips. NCHW in; the net computes in
    ``compute_dtype`` (default: its parameters' dtype)."""

    def __init__(self, n_classes: int, stage: int = 1,
                 resn50_dropout: bool = True):
        super().__init__()
        if stage not in (1, 2):
            raise ValueError(f"AdapNet++ has stages 1 and 2, not {stage}")
        self.stage = stage
        self.compute_dtype: Optional[torch.dtype] = None
        self.encoder_mod1 = Encoder(resn50_dropout)
        if stage == 1:
            self.eASPP = EASPP()
        else:
            self.encoder_mod2 = Encoder(resn50_dropout)
            self.eASPP_mod1 = EASPP()
            self.eASPP_mod2 = EASPP()
            self.ssma_s2 = SSMA(24, 6)
            self.ssma_s1 = SSMA(24, 6)
            self.ssma_res = SSMA(256, 16)
        self.decoder = Decoder(n_classes, fusion=stage == 2)

    def set_dropout_generator(self, generator: torch.Generator):
        """The generator the layer3[2] dropout draws from in train mode."""
        set_dropout_generator(self, generator)

    def _run(self, mod1, mod2, aux: bool):
        dt = self.compute_dtype or self.encoder_mod1.Conv_0.weight.dtype
        m1, s2_1, s1_1 = self.encoder_mod1(mod1.to(dt))
        if self.stage == 1:
            return self.decoder(self.eASPP(m1), s1_1, s2_1, aux)
        if mod2 is None:
            raise ValueError("stage-2 AdapNet needs two modalities")
        m2, s2_2, s1_2 = self.encoder_mod2(mod2.to(dt))
        skip2 = self.ssma_s2(s2_1, s2_2)
        skip1 = self.ssma_s1(s1_1, s1_2)
        x = self.ssma_res(self.eASPP_mod1(m1), self.eASPP_mod2(m2))
        return self.decoder(x, skip1, skip2, aux)

    def forward(self, mod1, mod2=None) -> List[torch.Tensor]:
        """``[res, aux1, aux2]``: (B, C, H, W) f32 logits each."""
        return self._run(mod1, mod2, aux=True)

    def logits(self, mod1, mod2=None) -> torch.Tensor:
        """``res`` alone (the aux heads not computed)."""
        return self._run(mod1, mod2, aux=False)[0]


def build_adapnet(config) -> AdapNet:
    """Factory from the SEMANTIC_2D_MODEL config section; a bf16
    ``compute_dtype`` is set on the (f32) module."""
    net = AdapNet(n_classes=int(config.n_classes),
                  stage=int(config.get("stage", 1)),
                  resn50_dropout=bool(config.get("resn50_dropout", True)))
    if config.get("compute_dtype") in ("bfloat16", "bf16"):
        net.compute_dtype = torch.bfloat16
    return net


def _storage(model: nn.Module) -> Tuple[int, ...]:
    """The address of every parameter and buffer of ``model``, its
    submodules' included."""
    ptrs, modules = [], [model]
    for m in modules:
        for t in m._parameters.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        for t in m._buffers.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        modules.extend(m._modules.values())
    return tuple(ptrs)


class SegmenterAdapter:
    """Pipeline-facing adapter: NHWC frames in, NHWC logits out. ``image``
    is (h, w, 3) in 0..255, ``depth`` (h, w); the image is scaled to [0, 1]
    and the depth repeated to 3 channels (reference normalisation). A
    stage-1 model sees the image where ``input_mode`` is "image", else the
    depth.

    A call replays a CUDA graph of the whole forward, frames to logits,
    when both inputs are CUDA tensors, the model is in eval mode, no
    ``TorchDispatchMode`` is active (``tracing.nan_guard``,
    ``FlopCounterMode``) and the stream is not capturing; any other call
    (the CPU, train mode) runs eager. The graphs are kept by
    ``cuda_graphs.SignatureGraphs``, one per :meth:`_signature`: the first
    call at one runs eager, the second captures, later ones replay; the
    logits returned are a copy of the graph's, which the next replay
    overwrites. A parameter or buffer whose storage moved (``.to(...)``,
    ``load_state_dict(assign=True)``) drops every graph; an in-place
    change is read by the next replay. Counters (``utils/tracing``):
    ``adapnet.eager``, ``adapnet.captures``, ``adapnet.replays``."""

    def __init__(self, model: AdapNet, input_mode: str = "tof_depth"):
        self.model = model
        self.input_mode = input_mode
        self._graphs = SignatureGraphs("adapnet")

    def apply_fn(self, image, depth):
        return self.apply_fn_batched(image[None], depth[None])[0]

    def _signature(self, images, depths) -> tuple:
        """What a graph is kept by: each input's shape (batch, height,
        width), dtype and device, the model's compute dtype and the
        input mode."""
        return (tuple(images.shape), images.dtype, images.device,
                tuple(depths.shape), depths.dtype, depths.device,
                self.model.compute_dtype, self.input_mode)

    def _logits(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        img = (inputs["images"] / 255.0).permute(0, 3, 1, 2)
        dep = inputs["depths"][:, None].expand(-1, 3, -1, -1)
        if self.model.stage == 1:
            mod1 = img if self.input_mode == "image" else dep
            return self.model.logits(mod1).permute(0, 2, 3, 1)
        return self.model.logits(img, dep).permute(0, 2, 3, 1)

    @torch.no_grad()
    def apply_fn_batched(self, images, depths):
        """(B, h, w, 3) images, (B, h, w) depths -> (B, h, w, C) f32
        logits. Inference BatchNorm: each sample independent of the
        batch."""
        inputs = {"images": images, "depths": depths}
        if not (_on_card(inputs) and not self.model.training
                and _get_current_dispatch_mode() is None):
            tracing.count("adapnet.eager")
            return self._logits(inputs)
        return self._graphs(self._signature(images, depths),
                            _storage(self.model), inputs, self._logits,
                            _capture)
