"""What the preprocessing steps share: mesh files by extension and the
camera views of ``fuse``.

Port of ``tools/preprocess/common.py`` (the reference's mesh-fusion
``common.py`` Mesh IO and ``2_fusion.py:99-152`` Fibonacci-sphere view
sampling), on the port's ``utils/meshio.py``.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np

from ..utils.meshio import read_off, read_ply, write_obj, write_off, write_ply

__all__ = ["load_mesh", "save_mesh", "mesh_files", "fibonacci_sphere_views",
           "look_at_view"]


def load_mesh(path: str):
    """(vertices, faces) of an .off or .ply file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".off":
        return read_off(path)
    if ext == ".ply":
        return read_ply(path)
    raise ValueError(f"unsupported mesh format {ext}")


def save_mesh(path: str, vertices, faces, normals=None):
    """Write an .off, .ply or .obj file by ``path``'s extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".off":
        write_off(path, vertices, faces)
    elif ext == ".ply":
        write_ply(path, vertices, faces, normals=normals)
    elif ext == ".obj":
        write_obj(path, vertices, faces)
    else:
        raise ValueError(f"unsupported mesh format {ext}")


def mesh_files(directory: str, patterns=("*.off",)):
    """The files of ``directory`` matching ``patterns``, sorted."""
    return sorted(sum((glob.glob(os.path.join(directory, p))
                       for p in patterns), []))


def fibonacci_sphere_views(n_views: int, radius: float = 1.0) -> np.ndarray:
    """(n_views, 3) camera centres on a Fibonacci sphere."""
    pts = []
    offset = 2.0 / n_views
    increment = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(n_views):
        y = ((i * offset) - 1) + offset / 2
        r = math.sqrt(max(0.0, 1 - y * y))
        phi = i * increment
        pts.append([math.cos(phi) * r * radius, y * radius,
                    math.sin(phi) * r * radius])
    return np.asarray(pts, np.float32)


def look_at_view(eye: np.ndarray, target=np.zeros(3),
                 up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """world -> camera matrix looking from ``eye`` at ``target`` (z
    forward, y down, x right)."""
    fwd = target - eye
    n = np.linalg.norm(fwd)
    fwd = fwd / max(n, 1e-12)
    upv = up if abs(np.dot(fwd, up)) < 0.99 else np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return np.linalg.inv(c2w).astype(np.float32)
