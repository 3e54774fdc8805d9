"""Convert a reference PyTorch checkpoint (``.pth.tar``) into the port's
checkpoint format: the Flax-layout msgpack that ``test_fusion``,
``train_fusion``'s resume and the JAX package all read
(``utils/checkpoints.py``).

Port of ``tools/convert_checkpoint.py``, with its flags::

  python -m segfusion_tpu_torch.convert_checkpoint --type fusion \\
      --config configs/fusion/replica_accuracy.yaml \\
      --in best.pth.tar --out fusion_best.ckpt
  python -m segfusion_tpu_torch.convert_checkpoint --type adapnet \\
      --stage 2 --n-classes 30 --in adapnet_best.pth.tar \\
      --out adapnet_best.ckpt

``--config`` (the FUSION_MODEL section fixes the layer order) is read with
PyYAML; where it is not installed ``load_config`` raises. ``--resx`` /
``--resy`` are accepted as the tool takes them: the port builds its
modules without a dummy input, so they change nothing. The mapping is
``utils/torch_convert.py``'s.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from .models.adapnet import build_adapnet
from .models.fusionnet import build_fusion_net
from .utils.checkpoints import save_checkpoint
from .utils.convert import to_flax
from .config import Config
from .utils.torch_convert import (convert_adapnet_state_dict,
                                  convert_fusionnet_state_dict,
                                  load_torch_checkpoint)

__all__ = ["convert_checkpoint", "main"]


def _strip(state: Dict[str, torch.Tensor], prefix: Optional[str]):
    if not prefix:
        return state
    pref = prefix + "."
    return {k[len(pref):] if k.startswith(pref) else k: v
            for k, v in state.items()}


def convert_checkpoint(kind: str, inp: str, out: str, fusion_model=None,
                       stage: int = 2, n_classes: int = 30,
                       strip_prefix: Optional[str] = None) -> torch.nn.Module:
    """Read ``inp``, map it onto the port's FusionNet (``kind`` "fusion",
    built from the ``fusion_model`` FUSION_MODEL section) or AdapNet++
    (``kind`` "adapnet", ``stage`` and ``n_classes``), write ``out``
    ({params, batch_stats, epoch 0}) and return the loaded module."""
    state = _strip(load_torch_checkpoint(inp), strip_prefix)
    if kind == "fusion":
        if fusion_model is None:
            raise ValueError("a fusion checkpoint needs the FUSION_MODEL "
                             "config (--config)")
        net = build_fusion_net(fusion_model)
        net.load_state_dict(convert_fusionnet_state_dict(state,
                                                         fusion_model))
    elif kind == "adapnet":
        net = build_adapnet(Config({"n_classes": int(n_classes),
                                    "stage": int(stage)}))
        net.load_state_dict(convert_adapnet_state_dict(state, stage,
                                                       n_classes))
    else:
        raise ValueError(f"unknown checkpoint type {kind!r}")
    params, stats = to_flax(net)
    save_checkpoint({"params": params, "batch_stats": stats, "epoch": 0},
                    out)
    return net


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--type", choices=("fusion", "adapnet"), required=True)
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", help="yaml config (for fusion conversion)")
    ap.add_argument("--stage", type=int, default=2)
    ap.add_argument("--n-classes", type=int, default=30)
    ap.add_argument("--resx", type=int, default=256)
    ap.add_argument("--resy", type=int, default=256)
    ap.add_argument("--strip-prefix", default=None,
                    help="strip a state-dict key prefix (e.g. 'module')")
    args = ap.parse_args(argv)
    fusion_model = None
    if args.type == "fusion":
        if not args.config:
            ap.error("--type fusion needs --config")
        from .config import load_config
        fusion_model = load_config(args.config).FUSION_MODEL
    convert_checkpoint(args.type, args.inp, args.out, fusion_model,
                       args.stage, args.n_classes, args.strip_prefix)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
