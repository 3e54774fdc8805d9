"""Binary little-endian PLY writer.

The port's own copy of ``write_ply`` from ``segfusion_tpu/utils/meshio.py``:
the same header and record layout, so both packages write byte-equal
files. Vertex order is kept as given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["write_ply"]


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              normals: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None):
    """Write a binary-little-endian PLY.

    Args:
      vertices: (n, 3) float.
      faces: (m, 3) int triangle indices.
      normals: optional (n, 3) float per-vertex normals.
      colors: optional (n, 3) uint8 RGB or (n, 4) uint8 RGBA (the semantic
        mesh carries the label id in the alpha channel).
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n, m = len(vertices), len(faces)
    has_n = normals is not None
    has_c = colors is not None
    n_c = 0 if not has_c else np.asarray(colors).shape[1]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        if n_c == 4:
            header += ["property uchar alpha"]
    header += [f"element face {m}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        # interleave vertex records
        cols: list = [vertices]
        if has_n:
            cols.append(np.asarray(normals, np.float32))
        float_part = np.concatenate(cols, axis=1).astype("<f4")
        if has_c:
            c = np.asarray(colors, np.uint8)
            rec = np.zeros(n, dtype=[("f", "<f4", float_part.shape[1]),
                                     ("c", "u1", n_c)])
            rec["f"] = float_part
            rec["c"] = c
            f.write(rec.tobytes())
        else:
            f.write(float_part.tobytes())
        frec = np.zeros(m, dtype=[("k", "u1"), ("idx", "<i4", 3)])
        frec["k"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
