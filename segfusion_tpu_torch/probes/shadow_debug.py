"""Roll direction (P12) and the shadow build at a tiny shape, on the card.

Port of ``tools/probe_shadow_debug.py``. ``roll1`` replaces the Pallas
kernel of ``roll_semantics`` (``:17``, call ``:23``):
``out[:, l] = x[:, (l - 1) % C]``, the direction of ``jnp.roll``, which
compiled ``pltpu.roll`` has; it is ``pallas_caps.roll_lanes`` at shift 1
(a warp shuffle for 128-lane rows, ``pallas_caps.roll_route``). ``main``
prints which direction the card's kernel has, then holds the full shadow
build (K2, ``ops/kernels/shadow_build.build_shadow``) against its plain
version on a (6, 8, 40) slot state with zero pad rows and z-tail, and
prints where they differ, as the tool did. The state is laid out with the
layout's own y-stride (SY = 12 at this shape; the tool's reshape assumed
Y + 2).

    python -m segfusion_tpu_torch.probes.shadow_debug [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rowvol
from ..ops.kernels import shadow_build as sb
from . import _lib

__all__ = ["roll1", "roll1_plain", "main", "launch_counts",
           "reset_launch_counts"]

SHAPE = (6, 8, 40)


def roll1_plain(x):
    return torch.roll(x, 1, 1)


def roll1(x):
    return _lib.lane_kernel(roll1, roll1_plain, "sf_probe_roll_lanes", x,
                            extra=(1,))


_WRAPPERS = (roll1,)


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def roll_semantics(dev):
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=dev).reshape(8, 128)
    y = roll1(x)
    _lib.check_equal("roll1", y, roll1_plain(x))
    v = int(y[0, 0].item())
    print(f"kernel roll1(x)[0] = x[{v}]  "
          f"({'jnp (l-s)' if v == 127 else 'forward (l+s)'})", flush=True)


def debug_state(layout) -> np.ndarray:
    """The tool's slot state: random (seed 1) components with the pad rows,
    the components of the last y-row that point past it and the z-tail
    zeroed."""
    L = layout
    rng = np.random.RandomState(1)
    geo = rng.randn(L.geo_rows, 128).astype(np.float32) * 0.3
    g5 = geo.reshape(L.X, L.SY, L.G, 8, 16)
    g5[:, 0] = 0.0
    g5[:, L.Y + 1:] = 0.0
    for c in (2, 3, 6, 7):
        g5[:, L.Y, :, c] = 0.0
    gz, sz = (L.Z - 1) // 16, (L.Z - 1) % 16
    for c in (1, 3, 5, 7):
        g5[:, :, gz, c, sz] = 0.0
    g5[:, :, gz, :, sz + 1:] = 0.0
    if gz + 1 < L.G:
        g5[:, :, gz + 1:] = 0.0
    return g5.reshape(L.geo_rows, 128)


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    roll_semantics(dev)

    L = rowvol.RowLayout.for_shape(SHAPE)
    geo = torch.as_tensor(debug_state(L), device=dev)
    want = sb.build_shadow_plain(geo, L).cpu().numpy()
    got = sb.build_shadow(geo, L, rowvol.shadow_tiling(L)[0]).cpu().numpy()
    diff = got != want
    print(f"total lanes {want.size}, differing {int(diff.sum())}",
          flush=True)
    if diff.any():
        w4 = want.reshape(L.X, L.Y, L.GK, 4, 32)
        g4 = got.reshape(L.X, L.Y, L.GK, 4, 32)
        d4 = w4 != g4
        print("mismatch count per component:",
              [int(d4[:, :, :, c, :].sum()) for c in range(4)], flush=True)
        print("mismatch count per y:",
              [int(d4[:, y].sum()) for y in range(L.Y)], flush=True)
        print("mismatch count per slot s:",
              [int(d4[..., s].sum()) for s in range(32)], flush=True)
        for i in np.argwhere(d4)[:6]:
            x, y, gk, c, s = i
            print(f"  at x={x} y={y} gk={gk} c={c} s={s}: "
                  f"want {int(w4[tuple(i)]) & 0xFFFFFFFF:08x} "
                  f"got {int(g4[tuple(i)]) & 0xFFFFFFFF:08x}", flush=True)
        raise RuntimeError("the shadow build disagrees with its plain "
                           "version")


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
