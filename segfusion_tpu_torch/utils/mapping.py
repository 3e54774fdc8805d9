"""The 256-entry id -> RGB map that colours semantic mesh exports.

The port's own copy of ``get_mapping`` from ``segfusion_tpu/utils/mapping.py``
with the 40-colour base palette it is built from (constant data, copied
verbatim, so exported meshes carry the same colours in both packages).
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_mapping"]

# Base 40-colour table: the seed block of the 256-entry mesh map.
_REPLICA_PALETTE = np.asarray([
    [31, 119, 180], [174, 199, 232], [255, 127, 14], [255, 187, 120],
    [44, 160, 60], [152, 223, 138], [214, 39, 40], [255, 152, 150],
    [148, 103, 189], [197, 176, 213], [140, 86, 75], [196, 156, 148],
    [227, 119, 194], [247, 182, 210], [123, 126, 129], [195, 200, 205],
    [188, 189, 34], [215, 219, 141], [23, 190, 207], [158, 218, 229],
    [57, 59, 121], [82, 84, 163], [107, 110, 207], [140, 162, 82],
    [181, 207, 107], [206, 219, 156], [140, 109, 49], [189, 158, 57],
    [231, 186, 82], [231, 203, 148], [132, 60, 57], [173, 73, 74],
    [214, 97, 107], [99, 121, 57], [231, 150, 156], [123, 65, 115],
    [165, 81, 148], [156, 158, 222], [206, 109, 189], [222, 158, 214],
], np.uint8)


def get_mapping(n: int = 256) -> np.ndarray:
    """256-entry id -> RGB map: random tail rows from two fixed numpy
    shuffles, overwritten on [0, 240) by the base palette under six channel
    permutations; entry 0 is black."""
    table = np.zeros((256, 3))
    r = np.linspace(0, 255, 256, dtype=np.uint8)
    table[:, 0] = r
    rng = np.random.RandomState(10)
    rng.shuffle(r)
    table[:, 1] = r
    rng = np.random.RandomState(10000)
    rng.shuffle(r)
    table[:, 2] = r

    rgb_map = _REPLICA_PALETTE.astype(np.float64)
    table[0:40, :] = rgb_map
    table[40:80, :] = rgb_map[:, [0, 2, 1]]
    table[80:120, :] = rgb_map[:, [1, 2, 0]]
    table[120:160, :] = rgb_map[:, [1, 0, 2]]
    table[160:200, :] = rgb_map[:, [2, 1, 0]]
    table[200:240, :] = rgb_map[:, [2, 0, 1]]
    table[0] = [0, 0, 0]
    return table[:n].astype(np.uint8)
