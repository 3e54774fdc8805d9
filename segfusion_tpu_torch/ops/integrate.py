"""Packed semantic key: (score, id) -> one monotonic int32.

Port of ``segfusion_tpu/ops/integrate.py:52-71``. The key state is combined
by scatter-max, so among duplicate updates to a voxel the highest score
wins deterministically (ties break toward the larger id).
"""

from __future__ import annotations

import torch

__all__ = ["pack_semantic_key", "unpack_semantic_key"]

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
