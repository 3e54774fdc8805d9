"""Loss functions: the fusion loss and the cross-entropy family.

Port of ``segfusion_tpu/utils/losses.py`` as plain functions on tensors.
Every ray is kept and a validity mask weights the reductions (the
reference filters rays by boolean indexing first: same value, static
shapes).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fusion_loss", "cross_entropy", "bootstrapped_cross_entropy",
           "multi_scale_cross_entropy", "get_loss_function"]

_EPS = 1e-10


def fusion_loss(est: torch.Tensor, target: torch.Tensor,
                mask: Optional[torch.Tensor] = None, w_l1: float = 1.0,
                w_l2: float = 10.0, w_cos: float = 0.1) -> torch.Tensor:
    """w_l1 * L1 + w_l2 * L2 + w_cos * (1 - cosine(sign(est),
    sign(target))). ``est`` / ``target`` (b, n_rays, n_points), ``mask``
    (b, n_rays) validity. The cosine term keeps the reference's quirk: the
    sign tensors are *reshaped* (not transposed) to (b, n_points, n_rays)
    and the cosine runs along axis 1, averaged over the valid rays."""
    b, n, p = est.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=est.device)
    m3 = mask.float()[:, :, None]
    n_elem = torch.clamp_min(m3.sum() * p, _EPS)

    diff = (est - target) * m3
    l1 = diff.abs().sum() / n_elem
    l2 = (diff * diff).sum() / n_elem

    x1 = torch.sign(est).reshape(b, p, n)
    x2 = torch.sign(target).reshape(b, p, n)
    mr = m3.expand(b, n, p).reshape(b, p, n)
    dot = (x1 * x2 * mr).sum(1)
    n1 = torch.sqrt(torch.clamp_min((x1 * x1 * mr).sum(1), 1e-8))
    n2 = torch.sqrt(torch.clamp_min((x2 * x2 * mr).sum(1), 1e-8))
    cos = dot / (n1 * n2)
    ray_valid = (mr.sum(1) > 0).float()
    l3 = ((1.0 - cos) * ray_valid).sum() / torch.clamp_min(ray_valid.sum(),
                                                          _EPS)
    return w_l1 * l1 + w_l2 * l2 + w_cos * l3


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         weight: Optional[torch.Tensor]):
    """Per-pixel negative log-likelihood (labels clipped into range) and
    the clipped labels."""
    c = logits.shape[-1]
    safe = labels.long().clamp(0, c - 1)
    nll = -torch.gather(F.log_softmax(logits, -1), -1, safe[..., None])[..., 0]
    if weight is not None:
        nll = nll * weight[safe]
    return nll, safe


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = 0) -> torch.Tensor:
    """Mean CE over the pixels whose label is in range and not
    ``ignore_index`` (the reference ignores class 0). ``logits`` (..., C),
    ``labels`` (...)."""
    c = logits.shape[-1]
    nll, _ = _nll(logits, labels, weight)
    valid = ((labels != ignore_index) & (labels >= 0) & (labels < c)).float()
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), _EPS)


def bootstrapped_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                               min_k: int, loss_th: float,
                               weight: Optional[torch.Tensor] = None,
                               ignore_index: int = -100) -> torch.Tensor:
    """Top-K hard-pixel CE per image: the pixels whose loss exceeds
    ``loss_th`` if the (min_k + 1)-th hardest does, else the ``min_k``
    hardest; the mean over the images."""
    b, c = logits.shape[0], logits.shape[-1]
    logits2 = logits.reshape(b, -1, c)
    labels2 = labels.reshape(b, -1)
    nll, _ = _nll(logits2, labels2, weight)
    valid = (labels2 != ignore_index) & (labels2 >= 0) & (labels2 < c)
    nll = torch.where(valid, nll, -torch.inf)   # invalid sorts last

    sorted_loss = torch.sort(nll, dim=1, descending=True).values
    use_threshold = sorted_loss[:, min_k] > loss_th
    finite = torch.isfinite(sorted_loss)
    above = finite & (sorted_loss > loss_th)
    idx = torch.arange(sorted_loss.shape[1], device=logits.device)
    topk = finite & (idx < min_k)
    sel = torch.where(use_threshold[:, None], above, topk)
    per_image = torch.where(sel, sorted_loss, 0.0).sum(1) \
        / torch.clamp_min(sel.float().sum(1), _EPS)
    return per_image.mean()


def multi_scale_cross_entropy(outputs: Sequence[torch.Tensor],
                              labels: torch.Tensor,
                              weights: Sequence[float] = (1.0, 0.6, 0.5),
                              ignore_index: int = 0,
                              class_weight: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Weighted sum of per-head CE losses: the segmentation objective
    1.0 CE(res) + 0.6 CE(aux1) + 0.5 CE(aux2)."""
    total = 0.0
    for w, out in zip(weights, outputs):
        total = total + w * cross_entropy(out, labels, class_weight,
                                          ignore_index)
    return total


def get_loss_function(loss_cfg, class_weight_path: Optional[str] = None):
    """TRAINING.loss config -> loss callable with the config's
    hyperparameters bound; class weights from a text file (``weight`` or
    ``class_weight_path``)."""
    if loss_cfg is None:
        return cross_entropy
    name = loss_cfg.get("name", "fusion")
    weight = None
    wpath = loss_cfg.get("weight") or class_weight_path
    if wpath:
        weight = torch.as_tensor(np.loadtxt(wpath), dtype=torch.float32)

    if name == "fusion":
        return functools.partial(fusion_loss,
                                 w_l1=float(loss_cfg.get("w_l1", 1.0)),
                                 w_l2=float(loss_cfg.get("w_l2", 10.0)),
                                 w_cos=float(loss_cfg.get("w_cos", 0.1)))
    if name == "cross_entropy":
        return functools.partial(cross_entropy, weight=weight)
    if name == "bootstrapped_cross_entropy":
        return functools.partial(
            bootstrapped_cross_entropy,
            min_k=int(loss_cfg.get("min_K", loss_cfg.get("min_k", 4096))),
            loss_th=float(loss_cfg.get("loss_th", 0.3)), weight=weight)
    if name == "multi_scale_cross_entropy":
        return functools.partial(multi_scale_cross_entropy,
                                 class_weight=weight)
    raise NotImplementedError(f"Loss {name} not implemented")
