"""Step 1: normalise meshes into the unit cube [-0.5, 0.5]^3 with padding.

Port of ``tools/preprocess/scale.py`` (the reference's mesh-fusion
``1_scale.py``). Writes each mesh as .off and the applied transform
(centre, scale) as .json beside it, so later steps can undo it.

Usage: python -m segfusion_tpu_torch.preprocess.scale --in_dir meshes/
       --out_dir scaled/ [--padding 0.1]
"""

from __future__ import annotations

import argparse
import json
import os

from .common import load_mesh, mesh_files, save_mesh


def scale_mesh(verts, padding: float = 0.1):
    """(vertices in the unit cube, centre, scale)."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    center = (lo + hi) / 2
    scale = float((hi - lo).max()) / (1.0 - padding)
    return (verts - center) / scale, center, scale


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--padding", type=float, default=0.1)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in mesh_files(args.in_dir, ("*.off", "*.ply", "*.obj")):
        verts, faces = load_mesh(path)
        verts, center, scale = scale_mesh(verts, args.padding)
        name = os.path.splitext(os.path.basename(path))[0]
        save_mesh(os.path.join(args.out_dir, name + ".off"), verts, faces)
        with open(os.path.join(args.out_dir, name + ".json"), "w") as fj:
            json.dump({"center": center.tolist(), "scale": scale}, fj)
        print(f"{name}: scale {scale:.4f}")


if __name__ == "__main__":
    main()
