"""Lane and row permutations and the f16 pack (P8), on the card.

Port of ``tools/probe_pallas_caps.py``, whose ``tryk`` (``:19``) ran seven
Pallas bodies (``:36-91``) to see which ops Mosaic lowers. Each body is a
kernel of ``csrc/probes.cu`` here, with its plain version:

| wrapper        | body (tools/probe_pallas_caps.py)                     |
| -------------- | ----------------------------------------------------- |
| f16_pack       | k_f16pack :36, f32 -> f16 (nearest even) bits b,      |
|                | (b << 16) OR b as u32 (int32 bits here)               |
| lane_swap      | k_slice64 :44, concat(x[:, 64:], x[:, :64])           |
| roll64         | k_roll :51, pltpu.roll(x, 64, 1): x[:, (l - 64) % C]  |
|                | (``roll_lanes`` at shift 64)                          |
| reshape_slices | k_reshape :59, (32, 512) as (8, 4, 512): three        |
|                | 128-lane slices summed, broadcast back                |
| qshift         | k_padq :68, rows shifted down one group of 4          |
| iota_mask      | k_iota_mask :76, the first group of 4 rows zeroed     |
| f16_unpack     | k_unpack :84, the high 16 bits of each word as f16    |

``roll_lanes`` is the lane roll at any shift, the kernel that ``roll64``
and ``shadow_debug.roll1`` launch; ``roll_route`` names the form it takes
on the card. ``main`` runs each body on the tool's inputs, holds it
against its plain version and prints its first values, as the tool did.

    python -m segfusion_tpu_torch.probes.pallas_caps [--device cpu]
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from . import _lib

__all__ = ["f16_pack", "lane_swap", "roll64", "roll_lanes", "roll_route",
           "reshape_slices", "qshift", "iota_mask", "f16_unpack", "PLAIN",
           "main", "launch_counts", "reset_launch_counts"]


# -- plain versions -----------------------------------------------------------

def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def f16_pack_plain(x):
    b = x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return _to_int32((b << 16) | b)


def lane_swap_plain(x):
    return torch.cat([x[:, 64:], x[:, :64]], dim=1)


def roll_lanes_plain(x, shift):
    return torch.roll(x, shift, 1)


def roll64_plain(x):
    return torch.roll(x, 64, 1)


def reshape_slices_plain(x):
    v = x.reshape(-1, 4, 512)
    w = v[:, 0, 0:128] + v[:, 1, 128:256] + v[:, 3, 384:512]
    return w[:, None, :].expand(-1, 4, 128).reshape(-1, 128).repeat(1, 4)


def qshift_plain(x):
    v = x.reshape(-1, 4, x.shape[1])
    zero = torch.zeros((1, 4, x.shape[1]), dtype=x.dtype, device=x.device)
    return torch.cat([zero, v])[:v.shape[0]].reshape(x.shape)


def iota_mask_plain(x):
    v = x.reshape(-1, 4, x.shape[1])
    q = torch.arange(v.shape[0], device=x.device)[:, None, None]
    return torch.where(q == 0, 0.0, v).reshape(x.shape)


def f16_unpack_plain(x):
    hi = (x.view(torch.int32).to(torch.int64) >> 16) & 0xFFFF
    h = torch.where(hi >= 2 ** 15, hi - 2 ** 16, hi).to(torch.int16)
    return h.view(torch.float16).float()


# -- wrappers -----------------------------------------------------------------

def f16_pack(x):
    return _lib.lane_kernel(f16_pack, f16_pack_plain, "sf_probe_f16_pack", x,
                            pass_c=False, out_dtype=torch.int32)


def lane_swap(x):
    return _lib.lane_kernel(lane_swap, lane_swap_plain, "sf_probe_lane_swap",
                            x, min_c=64)


def roll_route(x: torch.Tensor) -> str:
    """The form the lane roll of the (R, C) ``x`` takes on the card: a
    warp-shuffle kernel for 128-lane rows at a 16-byte-aligned address
    (the output always is), a loop over the lanes for anything else."""
    return ("warp shuffle" if x.shape[-1] == 128 and x.data_ptr() % 16 == 0
            else "lane loop")


def roll_lanes(x, shift: int):
    """out[:, l] = x[:, (l - shift) mod C] (jnp.roll's direction) for any
    int32 ``shift``, negative too; in the form ``roll_route`` names."""
    if not -2 ** 31 <= shift < 2 ** 31:
        raise ValueError(f"roll_lanes: shift {shift} is not an int32")
    return _lib.lane_kernel(roll_lanes,
                            functools.partial(roll_lanes_plain, shift=shift),
                            "sf_probe_roll_lanes", x, extra=(shift,))


def roll64(x):
    return _lib.lane_kernel(roll64, roll64_plain, "sf_probe_roll_lanes", x,
                            extra=(64,))


def reshape_slices(x):
    return _lib.lane_kernel(reshape_slices, reshape_slices_plain,
                            "sf_probe_reshape_slices", x, pass_c=False,
                            row_multiple=4, c=512)


def qshift(x):
    return _lib.lane_kernel(qshift, qshift_plain, "sf_probe_qshift", x,
                            row_multiple=4)


def iota_mask(x):
    return _lib.lane_kernel(iota_mask, iota_mask_plain, "sf_probe_iota_mask",
                            x, row_multiple=4)


def f16_unpack(x):
    return _lib.lane_kernel(f16_unpack, f16_unpack_plain,
                            "sf_probe_f16_unpack", x, pass_c=False)


_WRAPPERS = (f16_pack, lane_swap, roll64, reshape_slices, qshift, iota_mask,
             f16_unpack, roll_lanes)
PLAIN = {f16_pack: f16_pack_plain, lane_swap: lane_swap_plain,
         roll64: roll64_plain, reshape_slices: reshape_slices_plain,
         qshift: qshift_plain, iota_mask: iota_mask_plain,
         f16_unpack: f16_unpack_plain}


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def inputs(dev):
    """The tool's inputs: (8, 128) arange * 0.01 and (32, 512) arange."""
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=dev).reshape(8, 128) * 0.01
    x3 = torch.arange(32 * 512, dtype=torch.float32,
                      device=dev).reshape(32, 512)
    return {f16_pack: x, lane_swap: x, roll64: x, reshape_slices: x3,
            qshift: x3, iota_mask: x3, f16_unpack: x}


LABELS = {f16_pack: "f16 convert + bitcast u16 + u32 shift/or",
          lane_swap: "64-lane slice + lane concat",
          roll64: "roll by 64 lanes",
          reshape_slices: "major reshape + 128-lane comp slices",
          qshift: "major-axis concat (qshift)",
          iota_mask: "3-D iota + where",
          f16_unpack: "u32 -> f16 bitcast -> f32"}


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    for fn, x in inputs(dev).items():
        y = fn(x)
        _lib.check_equal(fn.__name__, y, PLAIN[fn](x))
        head = y.reshape(-1)[:4].cpu()
        if y.dtype == torch.int32:     # u32 bits, printed as the tool did
            head = head.to(torch.int64) & 0xFFFFFFFF
        print(f"OK    {LABELS[fn]}: {head.numpy()}", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
