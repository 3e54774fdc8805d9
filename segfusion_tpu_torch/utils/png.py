"""A PNG writer on the standard library (zlib), for the segmentation
strips: 8-bit RGB, every scanline filter 0 (none), one IDAT chunk."""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png"]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray):
    """Write an (H, W, 3) uint8 image to ``path``."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
