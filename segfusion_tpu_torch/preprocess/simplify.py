"""Step 3: watertight-mesh simplification.

Port of ``tools/preprocess/simplify.py`` (in place of the reference's
meshlabserver quadric decimation, ``3_simplify.py:56-61`` with
``simplification.mlx``: TargetFaceNum 5000, QualityThr 0.5). The default
method is the QEM edge-collapse decimator of ``utils/simplify.py``;
``--method cluster`` is grid vertex clustering.

Usage: python -m segfusion_tpu_torch.preprocess.simplify --in_dir fused/
       --out_dir simple/ [--method quadric|cluster] [--target 5000]
       [--quality_thr 0.5] [--cluster 0.01]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.simplify import simplify_cluster, simplify_quadric
from .common import load_mesh, mesh_files, save_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--method", choices=["quadric", "cluster"],
                    default="quadric")
    ap.add_argument("--target", type=int, default=5000,
                    help="quadric: target face count")
    ap.add_argument("--quality_thr", type=float, default=0.5)
    ap.add_argument("--cluster", type=float, default=0.01)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in mesh_files(args.in_dir):
        name = os.path.splitext(os.path.basename(path))[0]
        verts, faces = load_mesh(path)
        if args.method == "quadric":
            sv, sf = simplify_quadric(verts, faces, args.target,
                                      args.quality_thr)
        else:
            sv, sf = simplify_cluster(verts, faces, args.cluster)
        save_mesh(os.path.join(args.out_dir, name + ".off"),
                  np.asarray(sv), np.asarray(sf))
        print(f"{name}: {len(verts)}->{len(sv)} verts, "
              f"{len(faces)}->{len(sf)} faces")


if __name__ == "__main__":
    main()
