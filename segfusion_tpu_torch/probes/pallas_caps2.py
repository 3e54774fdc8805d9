"""Narrow stores, rolls, a regroup and a dynamic-offset copy (P9, P10), on
the card.

Port of ``tools/probe_pallas_caps2.py``: the four bodies of its ``tryk``
(``:18``, bodies ``:34-66``) and the dynamic-offset copy of its ``main``
(``:30``, call ``:82``, body ``k_dma`` ``:73``), each a kernel of
``csrc/probes.cu`` with its plain version:

| wrapper     | body (tools/probe_pallas_caps2.py)                        |
| ----------- | --------------------------------------------------------- |
| store16     | k_store16 :34, lanes 0:16 = 2 x[:, :16], 16:32 =          |
|             | 3 x[:, :16], the rest kept                                |
| rolls_sum   | k_rolls :42, rolls by 1, 15, 16 and 48 lanes summed       |
| narrow_pad  | k_narrow :52, x[:, :16] + roll(x, 16)[:, :16], zero-padded |
| regroup     | k_regroup :63, (A, 2H, D) -> (A, H, D): even + 2 * odd     |
| offset_copy | k_dma :73, block k copies rows [8k, 8k + 8) plus 1        |

Rolls have ``jnp.roll``'s direction: ``roll(x, s)[:, l] = x[:, l - s]``.
``rolls_sum`` and ``narrow_pad`` take the lane roll's two forms on the
card: a warp shuffle for 128-lane rows at a 16-byte-aligned address, a
loop over the lanes for anything else (``pallas_caps.roll_route`` names
the one they take).

    python -m segfusion_tpu_torch.probes.pallas_caps2 [--device cpu]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import _lib

__all__ = ["store16", "rolls_sum", "narrow_pad", "regroup", "offset_copy",
           "PLAIN", "main", "launch_counts", "reset_launch_counts"]


# -- plain versions -----------------------------------------------------------

def store16_plain(x):
    return torch.cat([x[:, :16] * 2.0, x[:, :16] * 3.0, x[:, 32:]], dim=1)


def rolls_sum_plain(x):
    return (torch.roll(x, 1, 1) + torch.roll(x, 15, 1)
            + torch.roll(x, 16, 1) + torch.roll(x, 48, 1))


def narrow_pad_plain(x):
    n = x[:, :16] + torch.roll(x, 16, 1)[:, :16]
    return F.pad(n, (0, x.shape[1] - 16))


def regroup_plain(x):
    A, G, D = x.shape
    r = x.reshape(A, G // 2, 2, D)
    return r[:, :, 0] + r[:, :, 1] * 2.0


def offset_copy_plain(x, n_blocks: int = 4, rows: int = 8):
    return x[:n_blocks * rows] + 1.0


# -- wrappers -----------------------------------------------------------------

def store16(x):
    return _lib.lane_kernel(store16, store16_plain, "sf_probe_store16", x,
                            min_c=32)


def rolls_sum(x):
    return _lib.lane_kernel(rolls_sum, rolls_sum_plain, "sf_probe_rolls_sum",
                            x)


def narrow_pad(x):
    return _lib.lane_kernel(narrow_pad, narrow_pad_plain,
                            "sf_probe_narrow_pad", x, min_c=16)


def regroup(x):
    """(A, 2H, D) f32 -> (A, H, D)."""
    if _lib.on_cpu("regroup", x):
        return regroup_plain(x)
    _lib.require("regroup", "x", x, torch.float32, ndim=3)
    A, G, D = x.shape
    if G % 2:
        raise ValueError(f"regroup: odd middle axis {tuple(x.shape)}")
    out = torch.empty((A, G // 2, D), dtype=torch.float32, device=x.device)
    _lib.launch("sf_probe_regroup", "regroup_kernel", x.device, x, out, D,
                out.numel())
    regroup.launches += 1
    return out


def offset_copy(x, n_blocks: int = 4, rows: int = 8):
    """(n_blocks * rows, C): block k copies rows [k rows, (k + 1) rows) of
    the f32 (R, C) ``x`` at its dynamic offset and adds 1."""
    if _lib.on_cpu("offset_copy", x):
        return offset_copy_plain(x, n_blocks, rows)
    R, C = _lib.lanes("offset_copy", x)
    if not 0 < n_blocks * rows <= R:
        raise ValueError(f"offset_copy: {n_blocks} x {rows} rows exceed "
                         f"{tuple(x.shape)}")
    out = torch.empty((n_blocks * rows, C), dtype=torch.float32,
                      device=x.device)
    _lib.launch("sf_probe_offset_copy", "offset_copy_kernel", x.device, x,
                out, n_blocks, rows * C)
    offset_copy.launches += 1
    return out


_WRAPPERS = (store16, rolls_sum, narrow_pad, regroup, offset_copy)
PLAIN = {store16: store16_plain, rolls_sum: rolls_sum_plain,
         narrow_pad: narrow_pad_plain, regroup: regroup_plain,
         offset_copy: offset_copy_plain}


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def inputs(dev):
    """The tool's inputs: (16, 128) arange, (8, 28, 16) arange and the
    (64, 128) arange of the copy."""
    x = torch.arange(16 * 128, dtype=torch.float32,
                     device=dev).reshape(16, 128)
    x3 = torch.arange(8 * 28 * 16, dtype=torch.float32,
                      device=dev).reshape(8, 28, 16)
    big = torch.arange(64 * 128, dtype=torch.float32,
                       device=dev).reshape(64, 128)
    return {store16: x, rolls_sum: x, narrow_pad: x, regroup: x3,
            offset_copy: big}


LABELS = {store16: "store at 16-lane offsets",
          rolls_sum: "rolls by 1/15/16/48",
          narrow_pad: "16-lane narrow slice + pad back",
          regroup: "major regroup (G) -> (GK, 2) + index",
          offset_copy: "dynamic-offset copy"}


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    for fn, x in inputs(dev).items():
        y = fn(x)
        _lib.check_equal(fn.__name__, y, PLAIN[fn](x))
        head = (y[0, :3] if fn is offset_copy else y.reshape(-1)[:4]).cpu()
        print(f"OK    {LABELS[fn]}: {head.numpy()}", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
