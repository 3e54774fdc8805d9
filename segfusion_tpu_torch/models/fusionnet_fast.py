"""Folded-BN matmul-form executor for FusionNet v3, inference and training.

Port of ``segfusion_tpu/models/fusionnet_fast.py``, the form the JAX
package's ``Pipeline`` runs by default on every bf16 v3 stream
(``SETTINGS.fused_net``, ``fused_net_train``; ``core/pipeline.py`` reads
both). Activations are channel-last ``(B, H, W, C)`` tensors, every
convolution a matmul over their ``(B*H*W, C)`` rows:

* inference BatchNorm is folded into the convolution before it
  (:func:`fold_v3`): ``W' = W * s``, ``b' = (b - mean) * s + beta`` with
  ``s = gamma / sqrt(var + 1e-5)``, all in float32;
* a 1x1 convolution is one ``(P, Cin) x (Cin, Cout)`` product; a 3x3 one
  (zero-padded SAME, dilation 1/3/9/27) sums its nine taps' products in
  tap order (``"dots9"``: one product with the taps' weights side by
  side, each tap's result moved to the pixels it feeds, so no shifted
  copy of the input is made) or is one product of the nine shifted
  slices side by side (``"im2col"``);
* products accumulate in float32 and the epilogue (bias, leaky 0.01 /
  relu / tanh) runs on the float32 accumulator before the one cast to the
  compute dtype; the tanh output stays float32;
* ``pack_vortex``: the four vortex branches' same-position convolutions as
  one block-diagonal product each (6 products a vortex instead of 18).

Float32 accumulation: on a card a bfloat16 product is ``torch.mm`` /
``torch.bmm`` with ``out_dtype=torch.float32`` (cuBLAS, float32 compute
and output), behind an autograd function that gives it the float32
form's gradients (the overload has no derivative); on the CPU a float32
product of the bfloat16-valued operands. :func:`exact_matmuls` keeps TF32
and cuBLAS's reduced-precision bfloat16 reductions off around them.

:func:`apply_v3_train` is the training forward in the same form, on the
module's own float32 master parameters so autograd puts the gradients on
them: train-mode BatchNorm in float32 (variance ``max(0, mean(x^2) -
mean^2)``, running averages moved by Flax's momentum 0.99) and
channel-broadcast dropout drawn from an explicit generator in the eager
module's order. The image-level vortex branch normalises the per-frame
values, as ``models/fusionnet.py`` does (the broadcast map's statistics
are those values').

:class:`FastV3` replays :func:`apply_v3` from a CUDA graph per input
signature on the card (its docstring says when), so the host issues one
graph launch a call in place of the executor's hundreds of kernel
launches; the kernels, and so the numbers, are the eager executor's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..utils import tracing
from .cuda_graphs import (_GRAPHS_MAX, _SEEN, SignatureGraphs,  # noqa: F401
                          _capture, _on_card)

__all__ = ["fold_v3", "apply_v3", "apply_v3_train", "FastV3",
           "exact_matmuls"]

_LEAKY_SLOPE = 0.01
_BN_EPS = 1e-5
_RATES = (1, 3, 9, 27)


@contextlib.contextmanager
def exact_matmuls():
    """cuBLAS products without TF32 and without reduced-precision
    bfloat16 reductions, cuDNN's (the pools' window sums) without TF32;
    the settings restored on exit."""
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, allow_tf32=False):
            yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


# -- folding ------------------------------------------------------------------

def _kernel(conv) -> torch.Tensor:
    """Conv2d weight (Cout, Cin, kh, kw) -> (kh*kw, Cin, Cout), taps
    row-major; a view of the parameter (autograd reaches it)."""
    w = conv.weight
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[1], w.shape[0])


@torch.no_grad()
def _fold_conv_bn(conv, bn=None):
    """(weight, bias) in float32 with inference BatchNorm ``bn`` folded
    in: (Cin, Cout) for a 1x1 convolution, (9, Cin, Cout) for a 3x3."""
    k = _kernel(conv).float()
    b = conv.bias.float()
    if bn is not None:
        s = bn.weight.float() / torch.sqrt(bn.running_var.float() + _BN_EPS)
        k = k * s
        b = (b - bn.running_mean.float()) * s + bn.bias.float()
    return (k[0] if k.shape[0] == 1 else k).contiguous(), b.contiguous()


def _fold_block(block):
    return [_fold_conv_bn(block.Conv_0, block.BatchNorm_0),
            _fold_conv_bn(block.Conv_1, block.BatchNorm_1)]


def _block_diag(mats):
    return torch.block_diag(*mats).contiguous()


def _pack_vortex(br):
    """The four branches' same-position weights as block-diagonal
    matrices: 1x1 (4 Cin, 4 Cout); 3x3 (9, 4 mid, 4 mid), tap by tap."""
    ins, d0s, d1s, outs = zip(*br)

    def taps(ws):
        return torch.stack([_block_diag([w[t] for w, _ in ws])
                            for t in range(9)])

    def bias(ws):
        return torch.cat([b for _, b in ws])

    return {"in": (_block_diag([w for w, _ in ins]), bias(ins)),
            "d0": (taps(d0s), bias(d0s)), "d1": (taps(d1s), bias(d1s)),
            "out": (_block_diag([w for w, _ in outs]), bias(outs))}


def _fold_vortex(vp, pack: bool):
    def cb(i):
        return _fold_conv_bn(getattr(vp, f"Conv_{i}"),
                             getattr(vp, f"BatchNorm_{i}"))

    br = [[cb(4 * bi + j) for j in range(1, 5)]
          for bi in range(len(vp.rates))]
    last = 1 + 4 * len(vp.rates)
    out = {"global": cb(0), "branches": br, "final": cb(last)}
    if pack:
        out["packed"] = _pack_vortex(br)
        out["branches"] = None
    return out


def _fold_pred(pred):
    if not pred.final:
        return [_fold_conv_bn(pred.Conv_0, pred.BatchNorm_0),
                _fold_conv_bn(pred.Conv_1, pred.BatchNorm_1)]
    return [_fold_conv_bn(pred.Conv_0, pred.BatchNorm_0),
            _fold_conv_bn(pred.Conv_1), _fold_conv_bn(pred.Conv_2)]


def _heads(net):
    if getattr(net, "stack_heads", False) or not hasattr(net, "Pred_0") \
            or not hasattr(net, "VortexPooling_0") \
            or hasattr(net, "VortexPooling_1"):
        raise ValueError("the folded executor runs FusionNet v3 with "
                         "unstacked heads only")
    names = ["head_tsdf", "head_sem"] if net.use_semantics \
        else ["FusionHead_0"]
    return {n: getattr(net, n) for n in names}


def fold_v3(net: nn.Module, pack_vortex: bool = False) -> Dict:
    """Fold a ``models.fusionnet.FusionNetV3`` (unstacked heads; a Flax
    tree goes through ``utils/convert.fusionnet_from_flax`` first) into
    the executor's weights: nested dicts and lists of float32 tensors on
    the net's device, with ``meta`` (use_semantics, n_points,
    output_scale)."""
    heads = {n: {"blocks": [_fold_block(getattr(h, f"Block_{i}"))
                            for i in range(h.gf)],
                 "vortex": _fold_vortex(h.VortexPooling_0, pack_vortex)}
             for n, h in _heads(net).items()}
    preds = [_fold_pred(getattr(net, f"Pred_{i}"))
             for i in range(net.n_preds)]
    n_points = getattr(net, f"Pred_{net.n_preds - 1}").Conv_2.out_channels
    return {"heads": heads,
            "vortex": _fold_vortex(net.VortexPooling_0, pack_vortex),
            "preds": preds,
            "meta": {"use_semantics": net.use_semantics,
                     "n_points": int(n_points),
                     "output_scale": float(net.output_scale)}}


# -- inference ----------------------------------------------------------------

class _Bf16Product(torch.autograd.Function):
    """(P, K) x (K, N) of bfloat16 operands with a float32 result on a
    card (``aten::mm``'s float32-output overload, which has no
    derivative); the gradients are the float32 form's: float32 products
    of the bfloat16 values, rounded to each operand's dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.float().t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x2.float().t() @ g).to(w.dtype)
        return gx, gw


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., Cin) x (Cin, Cout) -> (..., Cout) float32: products of
    ``x.dtype`` operands (``w`` cast to it) accumulated in float32;
    autograd reaches both."""
    w = w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype in (torch.float32, torch.float64):
        out = x2 @ w
    elif x.is_cuda:
        out = _Bf16Product.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(lead + (w.shape[-1],))


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "leaky":
        return F.leaky_relu(y, _LEAKY_SLOPE)
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    return y


def _epilogue(acc, b, act, dtype):
    """Bias and activation on the float32 accumulator, then the cast
    (tanh stays float32: the net's output)."""
    y = _act(acc + b, act)
    return y if act == "tanh" else y.to(dtype)


def _conv1x1(x, wb, act, dtype):
    w, b = wb
    return _epilogue(_dot(x, w), b, act, dtype)


def _taps(x: torch.Tensor, d: int):
    """The nine (B, H, W, C) tap slices of a zero-padded SAME 3x3
    convolution at dilation ``d``, row-major."""
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, d, d, d, d))
    return [xp[:, i * d:i * d + H, j * d:j * d + W]
            for i in range(3) for j in range(3)]


class _Bf16ColProduct(torch.autograd.Function):
    """``a`` (M, K) times each ``x[b]`` (K, P) of bfloat16 operands, a
    float32 (B, M, P) result on a card (``bmm``'s float32-output
    overload); the gradients are the float32 form's, rounded to each
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.bmm(a.expand(x.shape[0], -1, -1), x,
                         out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, x.float().transpose(1, 2)).sum(0).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gx = torch.matmul(a.float().t(), g).to(x.dtype)
        return ga, gx


def _col_product(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M, K) x (B, K, P) -> (B, M, P) float32, products of ``x.dtype``
    operands accumulated in float32 (autograd reaches both)."""
    a = a.to(x.dtype)
    if x.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, x)
    if x.is_cuda:
        return _Bf16ColProduct.apply(a, x)
    return torch.matmul(a.float(), x.float())


def _conv3x3_acc(x, w, rates, mode):
    """The float32 accumulator of a zero-padded SAME 3x3 convolution of
    ``x`` (B, H, W, G*k) whose G channel groups have dilations ``rates``
    (G > 1: ``w`` block-diagonal, (9, G*k, G*n)). ``dots9``: the nine
    taps' products summed in tap order, a tap reading past the border
    adding nothing (the zero pad's products are exact zeros), computed
    as one product of ``x`` with the taps' weights side by side into
    channel-first tap planes, each plane's window added where its pixels
    feed, so no shifted copy of the input is made; ``im2col``: one
    product of the nine shifted slices side by side."""
    B, H, W, K = x.shape
    G, N = len(rates), w.shape[-1]
    if mode == "im2col":
        per = [_taps(x[..., g * (K // G):(g + 1) * (K // G)], d)
               for g, d in enumerate(rates)]
        taps = [torch.cat([p[t] for p in per], -1) if G > 1 else per[0][t]
                for t in range(9)]
        return _dot(torch.cat(taps, -1), w.reshape(-1, N))
    if mode != "dots9":
        raise ValueError(f"unknown fused_conv3x3 {mode!r}")
    a = w.permute(0, 2, 1).reshape(9 * N, K)          # rows (tap, channel)
    y = _col_product(a, x.reshape(B, H * W, K).transpose(1, 2)).view(
        B, 9, G, N // G, H, W)
    with tracing.span("fusionnet.taps"):
        acc = y.new_zeros((B, G, N // G, H, W))
        for t in range(9):
            i, j = divmod(t, 3)
            for g, d in enumerate(rates):
                dy, dx = (i - 1) * d, (j - 1) * d
                h0, h1 = max(0, -dy), min(H, H - dy)
                w0, w1 = max(0, -dx), min(W, W - dx)
                if h0 < h1 and w0 < w1:
                    acc[:, g, :, h0:h1, w0:w1] += \
                        y[:, t, g, :, h0 + dy:h1 + dy, w0 + dx:w1 + dx]
    return acc.reshape(B, N, H, W).permute(0, 2, 3, 1).contiguous()


def _conv3x3(x, wb, rate, act, dtype, mode):
    w, b = wb
    return _epilogue(_conv3x3_acc(x, w, (rate,), mode), b, act, dtype)


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """count_include_pad 3x3/1/1 average of a (B, H, W, C) tensor: the
    window's float32 sum (a depthwise convolution with unit weights) over
    9, rounded once to ``x.dtype``."""
    C = x.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    ones = torch.ones((C, 1, 3, 3), dtype=acc, device=x.device)
    s = F.conv2d(x.permute(0, 3, 1, 2).to(acc), ones, padding=1, groups=C)
    return (s / 9.0).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _image_mean(x: torch.Tensor, dtype) -> torch.Tensor:
    """Each frame's float32 mean over (H, W) as (B, 1, 1, C) in
    ``dtype`` (the JAX package maps its executor over a block's frames)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(acc).mean((1, 2), keepdim=True).to(dtype)


def _run_vortex_packed(x, fw, dtype, mode):
    pk = fw["packed"]
    g = _conv1x1(_image_mean(x, dtype), fw["global"], None, dtype)
    pools = [x]
    for _ in _RATES[1:]:
        pools.append(_avg_pool_3x3(pools[-1]))
    y = _conv1x1(torch.cat(pools, -1), pk["in"], "relu", dtype)
    for key in ("d0", "d1"):
        w, b = pk[key]
        y = _epilogue(_conv3x3_acc(y, w, _RATES, mode), b, "relu",
                      dtype)
    y = _conv1x1(y, pk["out"], "relu", dtype)
    out = torch.cat([g.expand(y.shape[:3] + g.shape[3:]), y], -1)
    return _conv1x1(out, fw["final"], None, dtype)


def _run_vortex(x, fw, dtype, mode):
    if fw.get("packed") is not None:
        return _run_vortex_packed(x, fw, dtype, mode)
    g = _conv1x1(_image_mean(x, dtype), fw["global"], None, dtype)
    branches = [g.expand(x.shape[:3] + g.shape[3:])]
    xp = x
    for bi, rate in enumerate(_RATES):
        if bi:
            xp = _avg_pool_3x3(xp)
        c_in, c_d0, c_d1, c_out = fw["branches"][bi]
        b = _conv1x1(xp, c_in, "relu", dtype)
        b = _conv3x3(b, c_d0, rate, "relu", dtype, mode)
        b = _conv3x3(b, c_d1, rate, "relu", dtype, mode)
        branches.append(_conv1x1(b, c_out, "relu", dtype))
    return _conv1x1(torch.cat(branches, -1), fw["final"], None, dtype)


def _run_head(x, fh, dtype, mode):
    for c0, c1 in fh["blocks"]:
        y = _conv3x3(x, c0, 1, "leaky", dtype, mode)
        y = _conv3x3(y, c1, 1, "leaky", dtype, mode)
        x = torch.cat([x, y], -1)
    return _run_vortex(x, fh["vortex"], dtype, mode)


def _head_inputs(inputs, use_semantics, dtype):
    """The heads' channel-last inputs: values, weights and the depth
    (and semantic) frame, (B, H, W, C) in ``dtype``."""
    def bhwc(a):
        return (a if a.dim() == 4 else a[None]).to(dtype)

    vw = [bhwc(inputs["tsdf_values"]), bhwc(inputs["tsdf_weights"])]
    x_t = torch.cat(vw + [bhwc(inputs["tsdf_frame"])], -1)
    if not use_semantics:
        return [x_t]
    return [x_t, torch.cat(vw + [bhwc(inputs["semantic_frame"])], -1)]


def apply_v3(folded: Dict, inputs: Dict[str, torch.Tensor], *,
             dtype=torch.bfloat16, conv3x3: str = "dots9") -> torch.Tensor:
    """Inference forward of :func:`fold_v3`'s weights. ``inputs``: the
    net's NHWC dict, (B, H, W, C) or (H, W, C). Returns (B, H*W,
    n_points) float32 (tanh output times output_scale)."""
    meta = folded["meta"]
    with exact_matmuls():
        ys = []
        for x, n in zip(_head_inputs(inputs, meta["use_semantics"], dtype),
                        folded["heads"]):
            with tracing.span("fusionnet.head"):
                ys.append(_run_head(x, folded["heads"][n], dtype, conv3x3))
        with tracing.span("fusionnet.vortex"):
            y = _run_vortex(torch.cat(ys, -1), folded["vortex"], dtype,
                            conv3x3)
        with tracing.span("fusionnet.pred"):
            for i, pred in enumerate(folded["preds"]):
                y = _conv1x1(y, pred[0], "leaky", dtype)
                y = _conv1x1(y, pred[1], "leaky", dtype)
                if i == len(folded["preds"]) - 1:
                    y = _conv1x1(y, pred[2], "tanh", dtype)
    B, H, W, _ = y.shape
    return (meta["output_scale"] * y).reshape(B, H * W, meta["n_points"])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: (v if k == "meta" else _tree_map(fn, v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


class FastV3(nn.Module):
    """Fold once, apply many: :func:`fold_v3` of ``net`` with its weight
    matrices cast to ``dtype`` once (biases stay float32), held as
    buffers. Called like the net's forward, it returns :func:`apply_v3`'s
    (B, H*W, n_points) estimates.

    A call replays a CUDA graph of :func:`apply_v3` when every input is a
    CUDA tensor, gradients are off, no ``TorchDispatchMode`` is active
    (``tracing.nan_guard``, ``FlopCounterMode``) and the stream is not
    capturing; any other call runs eager. Graphs are kept per input
    signature (each input's key, shape, dtype and device) by
    ``cuda_graphs.SignatureGraphs``: the first call
    at a signature runs eager, the second warms up on the capture stream,
    captures and replays, later ones copy their inputs into the graph's
    static inputs and replay. The estimates returned are a copy of the
    graph's output, which the next replay overwrites. At most
    ``_GRAPHS_MAX`` (4) signatures are kept, the least recently used
    dropped with its graph (``fuse_many`` and the scene paths run at B =
    S*k); a buffer whose storage moved (``.to(...)``, a replaced buffer)
    drops every graph. A refold (``Pipeline.prepare_params``) makes a new
    executor, which starts with none. Counters (``utils/tracing``):
    ``fusionnet.eager``, ``fusionnet.captures``, ``fusionnet.replays``."""

    def __init__(self, net: nn.Module, *, dtype=torch.bfloat16,
                 conv3x3: str = "dots9", pack_vortex: bool = False):
        super().__init__()
        folded = fold_v3(net, pack_vortex)
        names = []

        def keep(t):
            t = t.to(dtype) if t.dim() > 1 else t
            name = f"w{len(names)}"
            self.register_buffer(name, t, persistent=False)
            names.append(name)
            return name

        self._spec = _tree_map(keep, folded)
        self.dtype = dtype
        self.conv3x3 = conv3x3
        self._graphs = SignatureGraphs("fusionnet")

    def _eager(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        folded = _tree_map(lambda n: getattr(self, n), self._spec)
        return apply_v3(folded, inputs, dtype=self.dtype,
                        conv3x3=self.conv3x3)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not (_on_card(inputs) and not torch.is_grad_enabled()
                and _get_current_dispatch_mode() is None):
            tracing.count("fusionnet.eager")
            return self._eager(inputs)
        ptrs = tuple(b.data_ptr() for b in self._buffers.values())
        key = tuple((k, tuple(t.shape), t.dtype, t.device)
                    for k, t in sorted(inputs.items()))
        return self._graphs(key, ptrs, inputs, self._eager, _capture)


# -- training -----------------------------------------------------------------

class _TrainWalk:
    """One training forward's dtype, 3x3 form and dropout draws."""

    def __init__(self, dtype, mode, generator):
        self.dtype = dtype
        self.mode = mode
        self.generator = generator
        self.acc = torch.float64 if dtype == torch.float64 else torch.float32

    def conv(self, x, conv, rate=1):
        """The float32 accumulator plus bias of ``conv`` on ``x``."""
        w = _kernel(conv)
        if w.shape[0] == 1:
            acc = _dot(x, w[0])
        else:
            acc = _conv3x3_acc(x, w, (rate,), self.mode)
        return acc + conv.bias.to(acc.dtype)

    def bn(self, x, bn):
        """Train-mode BatchNorm over every axis but the last, in float32;
        moves ``bn``'s running averages by its Flax momentum."""
        xf = x.to(self.acc)
        # the statistics reduce each channel's contiguous row: the
        # channel-last reduction's sums (a CPU's strided loop) are less
        # accurate, and ``mean(x^2) - mean^2`` cancels
        xt = xf.reshape(-1, xf.shape[-1]).t().contiguous()
        mean = xt.mean(1)
        var = torch.maximum(xt.square().mean(1) - mean.square(),
                            torch.zeros((), dtype=xf.dtype,
                                        device=xf.device))
        m = bn.flax_momentum
        with torch.no_grad():
            bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1.0 - m) * var)
        y = (xf - mean) * torch.rsqrt(var + bn.eps)
        return y * bn.weight.to(xf.dtype) + bn.bias.to(xf.dtype)

    def dropout(self, x, layer):
        """One keep draw per (frame, channel), kept values scaled by
        1 / keep: the eager ``Dropout``'s draws, in its order."""
        if layer.rate <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("apply_v3_train needs a generator when the "
                             "dropout rate is above 0")
        keep = 1.0 - layer.rate
        u = torch.rand(x.shape[:1] + x.shape[-1:], generator=self.generator,
                       device=x.device)[:, None, None]
        return torch.where(u < keep, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def cbl(self, x, conv, bn, drop):
        """conv -> bf16 round -> BN -> leaky -> cast -> dropout (Block)."""
        y = self.bn(self.conv(x, conv, 1).to(self.dtype), bn)
        return self.dropout(F.leaky_relu(y, _LEAKY_SLOPE).to(self.dtype),
                            drop)

    def block(self, x, blk):
        x = self.cbl(x, blk.Conv_0, blk.BatchNorm_0, blk.drop)
        return self.cbl(x, blk.Conv_1, blk.BatchNorm_1, blk.drop)

    def vortex(self, x, vp):
        def cbn(i, inp, relu):
            conv = getattr(vp, f"Conv_{i}")
            y = self.bn(self.conv(inp, conv, vp.rates[(i - 1) // 4]
                                  if conv.kernel_size[0] == 3 else 1),
                        getattr(vp, f"BatchNorm_{i}"))
            return (torch.relu(y) if relu else y).to(self.dtype)

        g = self.conv(_image_mean(x, self.dtype), vp.Conv_0).to(self.dtype)
        g = self.bn(g, vp.BatchNorm_0).to(self.dtype)
        branches = [g.expand(x.shape[:3] + g.shape[3:])]
        xp = x
        for bi in range(len(vp.rates)):
            if bi:
                xp = _avg_pool_3x3(xp)
            b = xp
            for j in range(1, 5):
                b = cbn(4 * bi + j, b, True)
            branches.append(b)
        out = cbn(1 + 4 * len(vp.rates), torch.cat(branches, -1), False)
        return self.dropout(out, vp.drop)

    def head(self, x, h):
        for i in range(h.gf):
            x = torch.cat([x, self.block(x, getattr(h, f"Block_{i}"))], -1)
        return self.vortex(x, h.VortexPooling_0)

    def pred(self, x, p):
        def cbl32(x, conv, bn):
            y = self.bn(self.conv(x, conv), bn)
            return self.dropout(F.leaky_relu(y, _LEAKY_SLOPE).to(self.dtype),
                                p.drop)

        x = cbl32(x, p.Conv_0, p.BatchNorm_0)
        if not p.final:
            return cbl32(x, p.Conv_1, p.BatchNorm_1)
        x = F.leaky_relu(self.conv(x, p.Conv_1), _LEAKY_SLOPE).to(self.dtype)
        return torch.tanh(self.conv(x, p.Conv_2))


def apply_v3_train(net: nn.Module, inputs: Dict[str, torch.Tensor], *,
                   dtype=torch.bfloat16, conv3x3: str = "dots9",
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Training forward of a ``FusionNetV3`` (unstacked heads) in matmul
    form on its own parameters (float32 masters, each product's weight
    cast to ``dtype``): returns (B, H*W, n_points) float32 and moves the
    BatchNorm running averages in place. Dropout draws from
    ``generator`` at each layer's rate; raises without one when a rate is
    above 0."""
    walk = _TrainWalk(dtype, conv3x3, generator)
    heads = _heads(net)
    with exact_matmuls():
        ys = [walk.head(x, h) for x, h in zip(
            _head_inputs(inputs, net.use_semantics, dtype), heads.values())]
        y = walk.vortex(torch.cat(ys, -1), net.VortexPooling_0)
        for i in range(net.n_preds):
            y = walk.pred(y, getattr(net, f"Pred_{i}"))
    B, H, W, C = y.shape
    return (net.output_scale * y).reshape(B, H * W, C)
