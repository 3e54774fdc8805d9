"""Step 2: watertight TSDF fusion of scaled meshes.

Port of ``tools/preprocess/fuse.py`` (the reference's mesh-fusion
``2_fusion.py:99-280``): render Fibonacci-sphere depth views of each mesh
with the host rasterizer (``utils/rasterize.py``), pull each depth toward
the camera by an offset and grey-erode it (the reference's thickening of
thin structures), fuse all views into a TSDF volume on the card
(``ops/tsdf_fusion.tsdf_from_depth_views``), and export the marching-cubes
mesh (``utils/mesh.py``), optionally with the sdf volume as hdf5.

Usage: python -m segfusion_tpu_torch.preprocess.fuse --in_dir scaled/
       --out_dir fused/ [--n_views 100] [--resolution 256]
       [--image_size 640] [--save_sdf] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..ops.tsdf_fusion import tsdf_from_depth_views
from ..utils import hdf5
from ..utils.mesh import marching_cubes
from ..utils.rasterize import rasterize_depth
from .common import (fibonacci_sphere_views, load_mesh, look_at_view,
                     mesh_files, save_mesh)


def erode_depth(d: np.ndarray) -> np.ndarray:
    """3x3 grey erosion (separable min filter) over the valid depth
    pixels. The reference erodes a depth map whose background is zfar,
    which grows silhouettes by one pixel; the rasterizer marks misses
    with 0, so they are lifted to +inf for the min and restored after."""
    di = np.where(d > 0, d, np.inf)
    e = np.minimum(di, np.minimum(np.roll(di, 1, 0), np.roll(di, -1, 0)))
    if e.shape[0] == 1:                 # one row: no vertical neighbours
        e[0] = di[0]
    else:                               # undo the roll's wrap at the rims
        e[0] = np.minimum(di[0], di[1])
        e[-1] = np.minimum(di[-1], di[-2])
    e2 = np.minimum(e, np.minimum(np.roll(e, 1, 1), np.roll(e, -1, 1)))
    if e2.shape[1] == 1:
        e2[:, 0] = e[:, 0]
    else:
        e2[:, 0] = np.minimum(e[:, 0], e[:, 1])
        e2[:, -1] = np.minimum(e[:, -1], e[:, -2])
    return np.where(np.isfinite(e2), e2, 0.0).astype(d.dtype)


def fuse_mesh(verts, faces, n_views=100, grid_res=256, image_size=640,
              truncation_factor=10.0, depth_offset=1.5, device="cuda"):
    """(tsdf, weights) host arrays of the fused ``grid_res``^3 volume over
    [-0.5, 0.5]^3, its origin and voxel size."""
    f = image_size * 1.2
    k = np.array([[f, 0, image_size / 2], [0, f, image_size / 2],
                  [0, 0, 1]], np.float32)
    voxel = 1.0 / grid_res
    depths, projs = [], []
    for eye in fibonacci_sphere_views(n_views, radius=1.2):
        view = look_at_view(eye)
        d = rasterize_depth(verts, faces, view, k, image_size, image_size,
                            znear=0.2, zfar=3.0)
        # a smaller depth grows the object (free space is positive)
        d = np.where(d > 0, np.maximum(d - depth_offset * voxel, 1e-6), 0.0)
        depths.append(erode_depth(d))
        projs.append((k @ view[:3, :4]).astype(np.float32))
    origin = np.array([-0.5, -0.5, -0.5], np.float32)
    tsdf, weights = tsdf_from_depth_views(
        np.stack(depths), np.stack(projs), (grid_res,) * 3, origin, voxel,
        truncation_factor * voxel, device=device)
    return tsdf.cpu().numpy(), weights.cpu().numpy(), origin, voxel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_views", type=int, default=100)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--image_size", type=int, default=640)
    ap.add_argument("--save_sdf", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in mesh_files(args.in_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        verts, faces = load_mesh(path)
        tsdf, _, origin, voxel = fuse_mesh(
            verts, faces, args.n_views, args.resolution, args.image_size,
            device=args.device)
        mv, mf, _ = marching_cubes(tsdf, 0.0, spacing=voxel)
        mv = mv + origin[None, :]
        save_mesh(os.path.join(args.out_dir, name + ".off"), mv, mf)
        print(f"{name}: {len(mv)} verts {len(mf)} faces")
        if args.save_sdf:
            bbox = np.stack([origin, origin + voxel * args.resolution],
                            axis=1)
            with hdf5.File(os.path.join(args.out_dir, name + "_sdf.hdf"),
                           "w") as hf:
                hf.create_dataset("sdf", shape=(1,) + tsdf.shape,
                                  data=tsdf[None], compression="gzip")
                hf.attrs["voxel_size"] = voxel
                hf.attrs["bbox"] = bbox


if __name__ == "__main__":
    main()
