"""Volume integration over the flat (X, Y, Z) state, and the packed
semantic key.

Port of ``segfusion_tpu/ops/integrate.py``. The TSDF update is a
scatter-add of the trilinear weights and of weight x value
(``index_add_``); the semantic update packs (score, id) into one monotonic
int32 key (score quantised to 23 bits, id in the low 8) combined by one
scatter-max (``scatter_reduce_(..., "amax")``), so among duplicate updates
to a voxel the highest score wins deterministically (ties break toward
the larger id). Invalid corners and rays scatter weight 0 / key 0 through
a clamped index: no-ops.

On the CPU ``index_add_`` sums in update order, as XLA's scatter does
there; on a card its atomics sum in any order (float32 rounding). The key
scatter-max is exact everywhere. The accumulator-form updates
(``integrate_numw``, ``integrate_semkey`` and their ``_lin`` forms) update
the state in place and return it, as the JAX package donates it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import _flatten_index, clamp_indices, valid_index_mask

__all__ = ["pack_semantic_key", "unpack_semantic_key", "integrate_tsdf",
           "integrate_semantics", "integrate_numw", "integrate_semkey",
           "IntegrationResult", "integrate_frame", "integrate_numw_lin",
           "integrate_semkey_lin"]

_SCORE_BITS = 23
_SCORE_SCALE = float((1 << _SCORE_BITS) - 1)  # scores are softmax probs


def pack_semantic_key(scores: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """score in [0, 1] quantised to 23 bits, id in the low 8 bits."""
    q = torch.clamp(torch.round(scores.float() * _SCORE_SCALE),
                    0.0, _SCORE_SCALE).to(torch.int32)
    return q * 256 + ids.to(torch.int32)


def unpack_semantic_key(key: torch.Tensor):
    """-> (scores f32, ids uint8)."""
    ids = (key % 256).to(torch.uint8)
    scores = (key // 256).float() / _SCORE_SCALE
    return scores, ids


def _corner_mask(valid, mask):
    return valid if mask is None else valid & mask[:, None, None]


def _scatter_add_geo(num_flat, w_flat, lin, valid, values, weights):
    w = torch.where(valid, weights.float(), 0.0)
    lin = lin.reshape(-1)
    w_flat.index_add_(0, lin, w.reshape(-1))
    num_flat.index_add_(0, lin, (w * values.float()[:, :, None]).reshape(-1))


def _keys(ids, scores, valid):
    n, p = valid.shape[:2]
    if ids.dim() == 1:
        ids = ids[:, None].expand(n, p)
        scores = scores[:, None].expand(n, p)
    key = pack_semantic_key(scores, ids)[:, :, None].expand(n, p, 8)
    return torch.where(valid, key, 0).reshape(-1)


def integrate_tsdf(tsdf_volume: torch.Tensor, weights_volume: torch.Tensor,
                   values: torch.Tensor, indices: torch.Tensor,
                   weights: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Explicit-value form: scatter-add (n, p) ``values`` through the
    (n, p, 8, 3) corner ``indices`` and weights into zero volumes dw and
    dnum, then ``v' = (w v + dnum) / (w + dw)`` where dw > 0. ``mask``
    (n,) drops whole rays. Returns new (tsdf, weights) f32 volumes."""
    shape = tuple(tsdf_volume.shape)
    valid = _corner_mask(valid_index_mask(indices, shape), mask)
    lin = _flatten_index(clamp_indices(indices, shape), shape)
    dev = tsdf_volume.device
    nvox = tsdf_volume.numel()
    dw = torch.zeros(nvox, dtype=torch.float32, device=dev)
    dnum = torch.zeros(nvox, dtype=torch.float32, device=dev)
    _scatter_add_geo(dnum, dw, lin, valid, values, weights)
    dw, dnum = dw.reshape(shape), dnum.reshape(shape)
    w_old = weights_volume.float()
    v_old = tsdf_volume.float()
    new_w = w_old + dw
    new_v = torch.where(dw > 0, (w_old * v_old + dnum)
                        / torch.clamp_min(new_w, 1e-12), v_old)
    return new_v, new_w


def integrate_semantics(semantics_volume: torch.Tensor,
                        scores_volume: torch.Tensor, ids: torch.Tensor,
                        scores: torch.Tensor, indices: torch.Tensor,
                        mask: Optional[torch.Tensor] = None):
    """Winner-takes-max-score labels over explicit (uint8 ids, f32
    scores) volumes; per-ray (n,) or per-sample (n, p) ``ids``/``scores``.
    Returns new (ids uint8, scores f32) volumes."""
    shape = tuple(semantics_volume.shape)
    valid = _corner_mask(valid_index_mask(indices, shape), mask)
    lin = _flatten_index(clamp_indices(indices, shape), shape).reshape(-1)
    key = pack_semantic_key(scores_volume.float(),
                            semantics_volume).reshape(-1)
    key = key.scatter_reduce(0, lin, _keys(ids, scores, valid), "amax")
    new_scores, new_ids = unpack_semantic_key(key.reshape(shape))
    return new_ids, new_scores


def integrate_numw(num_volume: torch.Tensor, w_volume: torch.Tensor,
                   values: torch.Tensor, indices: torch.Tensor,
                   weights: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Accumulator form (num = sum w v, w = sum w): two scatter-adds into
    the state, in place. Returns (num, w)."""
    shape = tuple(num_volume.shape)
    valid = _corner_mask(valid_index_mask(indices, shape), mask)
    lin = _flatten_index(clamp_indices(indices, shape), shape)
    _scatter_add_geo(num_volume.view(-1), w_volume.view(-1), lin, valid,
                     values, weights)
    return num_volume, w_volume


def integrate_semkey(semkey_volume: torch.Tensor, ids: torch.Tensor,
                     scores: torch.Tensor, indices: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed-key state: one scatter-max into it, in place."""
    shape = tuple(semkey_volume.shape)
    valid = _corner_mask(valid_index_mask(indices, shape), mask)
    lin = _flatten_index(clamp_indices(indices, shape), shape)
    semkey_volume.view(-1).scatter_reduce_(0, lin.reshape(-1),
                                           _keys(ids, scores, valid), "amax")
    return semkey_volume


class IntegrationResult(NamedTuple):
    tsdf: torch.Tensor
    weights: torch.Tensor
    semantics: Optional[torch.Tensor]
    scores: Optional[torch.Tensor]


def integrate_frame(tsdf_volume, weights_volume, semantics_volume,
                    scores_volume, values, indices, weights, mask=None,
                    ids=None, scores=None, update_semantics: bool = False
                    ) -> IntegrationResult:
    """:func:`integrate_tsdf`, and with ``update_semantics``
    :func:`integrate_semantics`, of one frame."""
    new_tsdf, new_w = integrate_tsdf(tsdf_volume, weights_volume, values,
                                     indices, weights, mask)
    if update_semantics:
        new_ids, new_scores = integrate_semantics(
            semantics_volume, scores_volume, ids, scores, indices, mask)
    else:
        new_ids, new_scores = semantics_volume, scores_volume
    return IntegrationResult(new_tsdf, new_w, new_ids, new_scores)


def integrate_numw_lin(num_volume: torch.Tensor, w_volume: torch.Tensor,
                       values: torch.Tensor, lin: torch.Tensor,
                       valid: torch.Tensor, weights: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """:func:`integrate_numw` through the clamped linear indices and
    validity of ``geometry.interpolation_corners_factored``."""
    _scatter_add_geo(num_volume.view(-1), w_volume.view(-1), lin,
                     _corner_mask(valid, mask), values, weights)
    return num_volume, w_volume


def integrate_semkey_lin(semkey_volume: torch.Tensor, ids: torch.Tensor,
                         scores: torch.Tensor, lin: torch.Tensor,
                         valid: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`integrate_semkey` through precomputed linear indices."""
    semkey_volume.view(-1).scatter_reduce_(
        0, lin.reshape(-1), _keys(ids, scores, _corner_mask(valid, mask)),
        "amax")
    return semkey_volume
