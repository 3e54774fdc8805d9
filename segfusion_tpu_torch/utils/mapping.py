"""Semantic label maps: class names, colour palettes and id mappings.

The port's own copy of ``segfusion_tpu/utils/mapping.py``: the Replica
30-class and NYU-40/NYU-20 names, the Replica and ScanNet palettes, the
NYU-20 benchmark subset, the ScanNet raw-id -> NYU-40 lookup from the
official tsv, and the 256-entry id -> RGB map that colours semantic mesh
exports. Names and palettes are constant data copied verbatim, so metric
tables and exported meshes carry the same labels and colours in both
packages.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

__all__ = ["REPLICA_CLASSES", "NYU40_CLASSES", "NYU20_CLASSES",
           "get_mapping", "replica_color_palette", "nyu40_color_palette",
           "nyu20_color_palette", "scannet_color_palette",
           "scannet_main_ids", "scannet_to_nyu40_map", "nyu40_to_nyu20_map"]

# Replica 30-label set (reference utils/mapping.py:77-109; class 0 =
# undefined/free space).
REPLICA_CLASSES: List[str] = [
    "undefined", "beanbag", "bed", "bike", "book", "cabinet", "ceiling",
    "chair", "clothing", "container", "curtain", "cushion", "door", "floor",
    "indoor-plant", "lamp", "refrigerator", "rug", "shelf", "sink", "sofa",
    "stair", "structure", "table", "tv-screen", "tv-stand", "wall",
    "wall-cabinet", "wall-decoration", "window",
]

# NYU-v2 40-label set (reference utils/mapping.py:157-200).
NYU40_CLASSES: List[str] = [
    "undefined", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "blinds", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "floor mat",
    "clothes", "ceiling", "books", "refridgerator", "television", "paper",
    "towel", "shower curtain", "box", "whiteboard", "person", "nightstand",
    "toilet", "sink", "lamp", "bathtub", "bag", "otherstructure",
    "otherfurniture", "otherprop",
]

# 20-class ScanNet benchmark subset (reference utils/mapping.py:202-225).
NYU20_CLASSES: List[str] = [
    "undefined", "wall", "floor", "cabinet", "bed", "chair", "sofa", "table",
    "door", "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

# Base 40-color table used for Replica semantic rendering and as the seed
# block of the 256-entry mesh map (reference utils/mapping.py:4-46).
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

# ScanNet NYU-40 palette (reference utils/mapping.py:111-154; entry i colors
# NYU-40 class i, entry 0 = undefined/black).
_SCANNET_PALETTE = np.asarray([
    [0, 0, 0], [174, 199, 232], [152, 223, 138], [31, 119, 180],
    [255, 187, 120], [188, 189, 34], [140, 86, 75], [255, 152, 150],
    [214, 39, 40], [197, 176, 213], [148, 103, 189], [196, 156, 148],
    [23, 190, 207], [178, 76, 76], [247, 182, 210], [66, 188, 102],
    [219, 219, 141], [140, 57, 197], [202, 185, 52], [51, 176, 203],
    [200, 54, 131], [92, 193, 61], [78, 71, 183], [172, 114, 82],
    [255, 127, 14], [91, 163, 138], [153, 98, 156], [140, 153, 101],
    [158, 218, 229], [100, 125, 154], [178, 127, 135], [120, 185, 128],
    [146, 111, 194], [44, 160, 44], [112, 128, 144], [96, 207, 209],
    [227, 119, 194], [213, 92, 176], [94, 106, 211], [82, 84, 163],
    [100, 85, 144],
], np.uint8)


def replica_color_palette() -> np.ndarray:
    """40-color base palette; row i colors Replica class id i
    (reference utils/mapping.py:4-46)."""
    return _REPLICA_PALETTE.copy()


def scannet_color_palette() -> np.ndarray:
    """41-color NYU-40 palette (reference utils/mapping.py:111-154)."""
    return _SCANNET_PALETTE.copy()


def nyu40_color_palette() -> np.ndarray:
    """Alias of the ScanNet NYU-40 palette (entry i = NYU-40 class i)."""
    return _SCANNET_PALETTE.copy()


def nyu20_color_palette() -> np.ndarray:
    """NYU-20 benchmark-subset palette: ScanNet palette rows at the main
    ids (reference dataset/scannet.py:63)."""
    return _SCANNET_PALETTE[np.asarray(scannet_main_ids())].copy()


def scannet_main_ids() -> List[int]:
    """NYU-40 ids of the 20 benchmark classes, in benchmark order, with a
    leading 0 for undefined (reference utils/mapping.py:227-250)."""
    return [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
            34, 36, 39]


def scannet_to_nyu40_map(tsv_path: Optional[str] = None,
                         max_raw_id: int = 1400) -> np.ndarray:
    """Raw ScanNet label id -> NYU-40 id lookup table, built from the
    official ``scannetv2-labels.combined.tsv`` (columns ``id`` and
    ``nyu40id``; reference utils/mapping.py:252-263). Ids without a mapping
    (or with no tsv available) map to 0."""
    lut = np.zeros(max_raw_id + 1, np.int32)
    if tsv_path is None or not os.path.exists(tsv_path):
        return lut
    with open(tsv_path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            try:
                raw = int(row["id"])
                nyu = int(row["nyu40id"])
            except (KeyError, ValueError):
                continue
            if 0 <= raw <= max_raw_id:
                lut[raw] = nyu
    return lut


def nyu40_to_nyu20_map() -> np.ndarray:
    """NYU-40 id -> NYU-20 benchmark index; non-benchmark classes map to 0
    (reference utils/mapping.py:266-277)."""
    main_ids = scannet_main_ids()
    lut = np.zeros(41, np.int32)
    for idx, nyu40 in enumerate(main_ids):
        lut[nyu40] = idx
    return lut


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
