"""The shadow build beside its copy floor (P1), on the card.

Port of ``tools/probe_shadow_variants.py``. ``dma_only`` replaces the
Pallas probe kernel ``dma_only`` (``:91``, body ``dma_only_kernel``
``:57``): the shadow build's reads and writes with no arithmetic,
``out[x, y*GK + gk] = bits(geo[(x * (Y + 2) + y + 1) * G + 2 gk])``, zero
where ``2 gk >= G``. ``main`` times the full shadow build (K2,
``ops/kernels/shadow_build.build_shadow``, f32 geo) beside it at 448^3
from CUDA-graph replays of back-to-back calls, where the TPU tool chained
each call on the last, and reports the build over its copy floor.

    python -m segfusion_tpu_torch.probes.shadow_variants [--device cpu]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import rowvol
from ..ops.kernels import shadow_build as sb
from . import _lib

__all__ = ["dma_only", "dma_only_plain", "dma_only_bytes", "main",
           "launch_counts", "reset_launch_counts"]

SHAPE = (448, 448, 448)


def dma_only_plain(geo: torch.Tensor, layout) -> torch.Tensor:
    """(shadow_rows, 128) int32: the f32 bits of the even z-groups of geo
    rows (x, y + 1), with the TPU probe's x-stride of Y + 2 rows."""
    L = layout
    rows = geo[:L.X * (L.Y + 2) * L.G].view(torch.int32) \
        .view(L.X, L.Y + 2, L.G, 128)[:, 1:L.Y + 1, 0:2 * L.GK:2]
    out = F.pad(rows, (0, 0, 0, L.GK - rows.shape[2]))
    return out.reshape(L.shadow_rows, 128)


def dma_only(geo: torch.Tensor, layout) -> torch.Tensor:
    """P1 on the card (``dma_only_kernel``), its plain version on the CPU;
    ``geo`` a contiguous (geo_rows, 128) f32 slot state."""
    if _lib.on_cpu("dma_only", geo):
        return dma_only_plain(geo, layout)
    L = layout
    _lib.require("dma_only", "geo", geo, torch.float32, (L.geo_rows, 128))
    out = torch.empty((L.shadow_rows, 128), dtype=torch.int32,
                      device=geo.device)
    _lib.launch("sf_probe_dma_only", "dma_only_kernel", geo.device, geo, out,
                L.X, L.Y, L.G, L.GK, L.Y + 2)
    dma_only.launches += 1
    return out


def dma_only_bytes(layout) -> int:
    """Least traffic of P1: the geo rows it reads (half of them) and the
    shadow it writes, once each."""
    return 2 * layout.shadow_rows * 128 * 4


_WRAPPERS = (dma_only,)


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def main(device="cuda", shape=SHAPE):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    L = rowvol.RowLayout.for_shape(shape)
    print(f"layout {tuple(shape)}: geo_rows={L.geo_rows} "
          f"({L.geo_rows * 512 / 2 ** 30:.2f} GiB f32) "
          f"shadow_rows={L.shadow_rows} "
          f"({L.shadow_rows * 512 / 2 ** 30:.2f} GiB)", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    geo = torch.rand((L.geo_rows, 128), generator=g, device=dev)
    floor = dma_only_bytes(L) / _lib.HBM_BYTES_PER_S * 1e3
    print(f"copy floor @3.35 TB/s: {floor:.4f} ms "
          f"({dma_only_bytes(L) / 1e9:.3f} GB: half the geo rows read, the "
          "shadow written)", flush=True)
    ty = rowvol.shadow_tiling(L)[0]
    # 4 calls a graph (each holds its 1.3 GiB output), replayed 5 times
    full = _lib.device_ms(lambda: sb.build_shadow(geo, L, ty), dev, 4, 5)
    copy = _lib.device_ms(lambda: dma_only(geo, L), dev, 4, 5)
    print(f"{'full shadow kernel (K2, f32 geo)':44s} "
          f"{_lib.fmt(full, '8.4f', ' ms/call')}", flush=True)
    print(f"{'copy only, same access pattern (P1)':44s} "
          f"{_lib.fmt(copy, '8.4f', ' ms/call')}", flush=True)
    if full is not None:
        print(f"shadow build over its copy floor: {full / copy:.3f} x P1, "
              f"{full / floor:.3f} x the traffic floor; P1 at "
              f"{floor / copy:.3f} of the 3.35 TB/s peak", flush=True)
    print("TY sweep: no counterpart -- the CUDA shadow build has no y-tile "
          "(one thread per output word)", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
