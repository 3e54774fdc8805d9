"""Mesh I/O: binary little-endian PLY writer and reader, OFF reader and
writer, OBJ export.

The port's own copy of ``segfusion_tpu/utils/meshio.py``: the same header
and record layouts, so both packages write byte-equal files and read the
same meshes. Vertex order is kept as given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["write_ply", "read_ply", "write_off", "read_off", "write_obj"]


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


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader (binary-LE or ascii) returning (vertices, faces).
    Supports the property layouts this package writes, plus common
    float/uchar vertex properties in other files."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        n_vert = n_face = 0
        vert_props = []  # (name, dtype_char)
        cur_elem = None
        while True:
            line = f.readline().strip().decode("ascii")
            if line == "end_header":
                break
            tok = line.split()
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur_elem = tok[1]
                if tok[1] == "vertex":
                    n_vert = int(tok[2])
                elif tok[1] == "face":
                    n_face = int(tok[2])
            elif tok[0] == "property" and cur_elem == "vertex":
                if tok[1] == "list":
                    continue
                vert_props.append((tok[2], tok[1]))

        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4",
                    "uint": "<u4", "short": "<i2", "ushort": "<u2"}
        if fmt == "ascii":
            verts = np.empty((n_vert, 3), np.float32)
            for i in range(n_vert):
                vals = f.readline().split()
                verts[i] = [float(v) for v in vals[:3]]
            faces = np.empty((n_face, 3), np.int32)
            for i in range(n_face):
                vals = f.readline().split()
                faces[i] = [int(v) for v in vals[1:4]]
            return verts, faces

        vdt = np.dtype([(nm, type_map[t]) for nm, t in vert_props])
        vdata = np.frombuffer(f.read(n_vert * vdt.itemsize), dtype=vdt)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]],
                         axis=1).astype(np.float32)
        fdt = np.dtype([("k", "u1"), ("idx", "<i4", 3)])
        fdata = np.frombuffer(f.read(n_face * fdt.itemsize), dtype=fdt)
        faces = fdata["idx"].astype(np.int32)
        return verts, faces


def write_off(path: str, vertices: np.ndarray, faces: np.ndarray):
    """OFF export (reference deps/mesh-fusion/libmcubes/exporter.py)."""
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(vertices)} {len(faces)} 0\n")
        for v in np.asarray(vertices):
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """OFF reader (reference deps/mesh-fusion/common.py mesh IO)."""
    with open(path) as f:
        tokens: list = []
        first = f.readline().strip()
        if first != "OFF":
            if first.startswith("OFF"):  # header glued to counts
                tokens.extend(first[3:].split())
            else:
                raise ValueError("not an OFF file")
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    nv, nf = int(tokens[0]), int(tokens[1])
    pos = 3
    verts = np.array(tokens[pos:pos + 3 * nv], np.float32).reshape(nv, 3)
    pos += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[pos])
        face = [int(t) for t in tokens[pos + 1:pos + 1 + k]]
        pos += 1 + k
        for i in range(1, k - 1):  # fan-triangulate polygons
            faces.append([face[0], face[i], face[i + 1]])
    return verts, np.asarray(faces, np.int32)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """OBJ export (1-indexed faces)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
