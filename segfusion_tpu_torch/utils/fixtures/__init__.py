"""A small orbax checkpoint written by the JAX package's
``save_checkpoint_orbax``, kept to hold the port's reader to orbax's own
output where orbax is not installed.

``orbax_small/`` is that checkpoint of :func:`orbax_small_state` at
:data:`SEED`; ``tests/test_torch_orbax.py`` writes it anew (``jax_leaves``
names the leaves it saves as ``jax.Array``, bfloat16 among them) and
checks that the copy here holds the same leaves. Its chunks are orbax's
zstd frames at level 1: Huffman-coded literals, FSE-coded sequences, the
label volume over several blocks.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

__all__ = ["ORBAX_SMALL", "SEED", "orbax_small_state", "JAX_LEAVES",
           "BF16_LEAVES"]

ORBAX_SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "orbax_small")
SEED = 18
# leaves written as jax.Array (the rest as numpy arrays and scalars)
JAX_LEAVES = (("params", "conv", "kernel"), ("params", "head", "kernel"))
# ... of them, those cast to bfloat16 (their float32 values are exact
# bfloat16 numbers)
BF16_LEAVES = (("params", "head", "kernel"),)


def orbax_small_state(seed: int = SEED) -> Dict:
    """The checkpoint's leaves in numpy: a network's weights, a piecewise
    constant uint8 label volume (262 KB, so its chunk spans several zstd
    blocks), a smooth float32 TSDF, small int32 counts, a mask and
    scalars."""
    rng = np.random.default_rng(seed)
    head = rng.standard_normal((32, 30)).astype(np.float32)
    head = (head.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    blocks = rng.integers(0, 30, (8, 8, 8)).astype(np.uint8)
    labels = np.repeat(np.repeat(np.repeat(blocks, 8, 0), 8, 1), 8, 2)
    salt = rng.random(labels.shape) < 0.02
    labels[salt] = rng.integers(0, 30, int(salt.sum())).astype(np.uint8)
    g = (np.arange(24, dtype=np.float32) - 11.5) * 0.05
    dist = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2
                   + g[None, None, :] ** 2) - 0.4
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 8, 16)).astype(
                np.float32), "bias": np.zeros(16, np.float32)},
            "head": {"kernel": head},
            "bn": {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(
                np.float32), "mean": rng.standard_normal(16)},
        },
        "labels": labels,
        "tsdf": np.clip(dist / 0.1, -1, 1).astype(np.float32),
        "counts": rng.poisson(3.0, 1000).astype(np.int32),
        "mask": rng.random(50) < 0.3,
        "step": np.asarray(1234, np.int64),
        "epoch": 7,
        "lr": 0.001,
    }
