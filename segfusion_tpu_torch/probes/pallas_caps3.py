"""A strided window copy against the same bytes contiguous (P11).

Port of ``tools/probe_pallas_caps3.py`` (``main`` ``:51``, bodies
``_win_kernel`` ``:27`` and ``_flat_kernel`` ``:40``), the question that
decides the z-masked dirty rebuild: does a copy of a (TY+2, Gb, 128)
window, with dynamic offsets on both major axes of the geo state viewed as
(rows_y, G, 128), cost much more than the same bytes contiguous?

- ``window_copy``: n windows of (WA, WB, 128) f32 from a (A, B, 128)
  source at ``offs[2k], offs[2k+1]``; the result is the first 128-lane row
  block, (WB, 128), of the last window;
- ``flat_copy``: n windows of (WN, 128) from a (R, 128) source at
  ``offs[2k]``; the result is the last window.

Offsets are clamped into the source (as lax.dynamic_slice clamps). The TPU
ran the copies one after another on one core, each window by one DMA into
VMEM; the card copies all windows in parallel, each split over blocks of
at most ``WINDOW_PART_ROWS`` 128-lane rows, each block's part landing in
its shared memory by the TMA's bulk copies (``csrc/probes.cu``,
``copy_route``).

    python -m segfusion_tpu_torch.probes.pallas_caps3 [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import _lib

__all__ = ["window_copy", "window_copy_plain", "flat_copy",
           "flat_copy_plain", "window_parts", "copy_route", "main",
           "launch_counts", "reset_launch_counts"]

REPS = 64
# the most 128-lane rows one block of the copy holds (kWindowPartRows in
# csrc/probes.cu)
WINDOW_PART_ROWS = 51


def _clamp(v: int, hi: int) -> int:
    return min(max(v, 0), hi)


def _copies_plain(src3, offs, wa, wb):
    """The copies one after another into one (wa, wb, 128) scratch, as the
    TPU ran them; returns the scratch."""
    A, B = src3.shape[:2]
    o = offs.tolist()
    scratch = torch.empty((wa, wb, 128), dtype=src3.dtype,
                          device=src3.device)
    for k in range(len(o) // 2):
        a, b = _clamp(o[2 * k], A - wa), _clamp(o[2 * k + 1], B - wb)
        scratch.copy_(src3[a:a + wa, b:b + wb])
    return scratch


def window_copy_plain(src: torch.Tensor, offs: torch.Tensor, wa: int,
                      wb: int) -> torch.Tensor:
    """(wb, 128): the last window's first row block."""
    return _copies_plain(src, offs, wa, wb)[0].clone()


def flat_copy_plain(src: torch.Tensor, offs: torch.Tensor, wn: int
                    ) -> torch.Tensor:
    """(wn, 128): the last window."""
    return _copies_plain(src[:, None], offs, wn, 1)[:, 0]


def window_parts(wa: int, wb: int) -> int:
    """The blocks one (wa, wb) window splits into on the card."""
    return -(-wa * wb // WINDOW_PART_ROWS)


def copy_route(wa: int, wb: int) -> str:
    """How each window's copy lands on the card."""
    return (f"bulk copies into shared memory, {window_parts(wa, wb)} "
            "blocks a window")


def _copy(name, src3, offs, wa, wb, out_rows):
    _lib.require(name, "offs", offs, torch.int32, ndim=1)
    A, B = src3.shape[:2]
    n_win = offs.numel() // 2
    if n_win < 1 or offs.numel() % 2 or not (0 < wa <= A and 0 < wb <= B):
        raise ValueError(f"{name}: window ({wa}, {wb}) or {offs.numel()} "
                         f"offsets do not fit a {tuple(src3.shape)} source")
    if src3.data_ptr() % 16 or n_win > 65535 or wa * wb >= 2 ** 31:
        raise ValueError(f"{name}: the bulk copies need a 16-byte-aligned "
                         "source, windows of fewer than 2^31 rows and at "
                         "most 65,535 of them")
    out = torch.empty((out_rows, 128), dtype=torch.float32,
                      device=src3.device)
    _lib.launch("sf_probe_window_copy", "window_copy_kernel", src3.device,
                src3, A, B, offs, n_win, wa, wb, out, out_rows)
    return out


def window_copy(src: torch.Tensor, offs: torch.Tensor, wa: int, wb: int
                ) -> torch.Tensor:
    """P11, strided form: ``src`` (A, B, 128) f32, ``offs`` (2n,) int32."""
    if _lib.on_cpu("window_copy", src, offs):
        return window_copy_plain(src, offs, wa, wb)
    _lib.require("window_copy", "src", src, torch.float32, ndim=3)
    if src.shape[2] != 128:
        raise ValueError("window_copy: src must have 128 lanes")
    out = _copy("window_copy", src, offs, wa, wb, wb)
    window_copy.launches += 1
    return out


def flat_copy(src: torch.Tensor, offs: torch.Tensor, wn: int
              ) -> torch.Tensor:
    """P11, contiguous form: ``src`` (R, 128) f32, ``offs`` (2n,) int32
    (the odd entries are not read)."""
    if _lib.on_cpu("flat_copy", src, offs):
        return flat_copy_plain(src, offs, wn)
    _lib.require("flat_copy", "src", src, torch.float32, ndim=2)
    if src.shape[1] != 128:
        raise ValueError("flat_copy: src must have 128 lanes")
    out = _copy("flat_copy", src[:, None], offs, wn, 1, wn)
    flat_copy.launches += 1
    return out


_WRAPPERS = (window_copy, flat_copy)


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def inputs(dev):
    """The tool's sources and offsets, drawn in its order from
    ``np.random.RandomState(0)``: name -> (wrapper, its arguments, bytes
    the 64 copies move, window shape) for the four cases."""
    RY, G = 8 * 450, 28           # 8 x-slabs of y-rows, 28 z-groups
    WY, WG = 58, 7                # (TY + 2, Gb) window
    rng = np.random.RandomState(0)
    x3 = torch.as_tensor(rng.rand(RY, G, 128).astype(np.float32), device=dev)
    x2 = x3.view(RY * G, 128)

    def offsets(first, second=None):
        o = np.zeros(2 * REPS, np.int32)
        o[0::2] = first
        if second is not None:
            o[1::2] = second
        return torch.as_tensor(o, device=dev)

    offs = offsets(rng.randint(0, RY - WY, REPS),
                   rng.randint(0, G - WG, REPS))
    offs_f = offsets(rng.randint(0, RY * G - WY * WG, REPS))
    GX, SEG = 4, 1624             # 4 slabs x (TY=56: (56 + 2) * 28 rows)
    XSL = RY * G // 12600         # view: (8, 12600, 128)
    x4 = x2.view(XSL, 12600, 128)
    offs_g = offsets(rng.randint(0, XSL - GX, REPS),
                     rng.randint(0, 12600 - SEG, REPS))
    offs_c = offsets(rng.randint(0, RY * G - GX * SEG, REPS))
    small, big = REPS * WY * WG * 512, REPS * GX * SEG * 512
    return {
        f"strided ({WY}, {WG}, 128) window":
            (window_copy, (x3, offs, WY, WG), small, (WY, WG)),
        "contiguous same bytes":
            (flat_copy, (x2, offs_f, WY * WG), small, (WY * WG, 1)),
        f"strided ({GX}, {SEG}, 128) win":
            (window_copy, (x4, offs_g, GX, SEG), big, (GX, SEG)),
        "contiguous same bytes (big)":
            (flat_copy, (x2, offs_c, GX * SEG), big, (GX * SEG, 1)),
    }


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    cases = inputs(dev)
    (x3, offs, WY, WG) = next(iter(cases.values()))[1]
    got = window_copy(x3, offs, WY, WG)
    yo, go = offs[-2].item(), offs[-1].item()
    if not torch.equal(got, x3[yo, go:go + WG]):
        raise RuntimeError("strided window copy: WRONG")
    print("strided window copy: OK bit-exact", flush=True)
    plain = {window_copy: window_copy_plain, flat_copy: flat_copy_plain}
    for name, (fn, args, byt, window) in cases.items():
        _lib.check_equal(fn.__name__, fn(*args), plain[fn](*args))
        ms = _lib.device_ms(lambda: fn(*args), dev, iters=10)
        route = copy_route(*window)
        if ms is None:
            print(f"{name:28s}: {_lib.fmt(ms)} [{route}]", flush=True)
            continue
        print(f"{name:28s}: {ms:7.3f} ms for {REPS} copies "
              f"({byt / ms / 1e6:7.1f} GB/s, {ms * 1e3 / REPS:6.2f} us/copy)"
              f" [{route}]", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
