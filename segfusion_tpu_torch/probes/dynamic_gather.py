"""Per-lane table lookups on the card (P6, P7).

Port of ``tools/probe_dynamic_gather.py``:

- ``gather_rows_sum`` replaces ``probe`` (``:25``, body ``:26``):
  ``out[i, j] = sum_{k < inner} table[(idx[i, j] + k) % S, j]``, f32 or u32
  (int32 tensors holding u32 bits; the add wraps);
- ``take_lanes`` replaces ``probe_axis1`` (``:91``, body ``:94``):
  ``out[i, j] = table[i, idx[i, j] % C]``.

``gather_rows_sum`` first writes the table lane-major into a scratch
(``lane_major_width``: each lane's entries in a row of their own, ending
with its first ``inner - 1`` entries again, padded to 16 bytes), so that
one output's ``inner`` entries lie side by side, then sums each output's
window from there (``rows_sum_route``). ``take_lanes`` takes a warp a
128-lane row, staged in shared memory, where the table and index lie at
16-byte-aligned addresses, and loops over the lanes otherwise
(``take_lanes_route``). Each result is held against its plain version
before it is timed.

    python -m segfusion_tpu_torch.probes.dynamic_gather [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import _lib

__all__ = ["gather_rows_sum", "gather_rows_sum_plain", "take_lanes",
           "take_lanes_plain", "take_lanes_route", "lane_major_width",
           "rows_sum_route", "main", "launch_counts", "reset_launch_counts"]

INNER = 8
# the term count the kernel reads as 16-byte vectors (kRowsSumVector in
# csrc/probes.cu)
ROWS_SUM_VECTOR = 8


def gather_rows_sum_plain(table: torch.Tensor, idx: torch.Tensor,
                          inner: int = INNER) -> torch.Tensor:
    """Shaped like ``idx``; summed in order of k from 0 (int32 adds wrap,
    as u32 adds do: torch on the CPU has no uint32 add)."""
    S = table.shape[0]
    out = torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    base = idx.long()
    for k in range(inner):
        out = out + torch.gather(table, 0, (base + k) % S)
    return out


def take_lanes_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(table, 1, idx.long() % table.shape[1])


def lane_major_width(S: int, inner: int) -> int:
    """The length of each lane's row in the lane-major scratch: the S
    entries and the first ``inner - 1`` again (at least the S), rounded up
    to a whole 16-byte vector."""
    return -(-(S + max(inner, 1) - 1) // 4) * 4


def rows_sum_route(inner: int) -> str:
    """How the kernel reads each output's window from the lane-major
    scratch: the probe's 8 terms as the 2 or 3 aligned 16-byte vectors
    over it, any other count one entry at a time."""
    return ("lane-major, 16-byte vectors" if inner == ROWS_SUM_VECTOR
            else "lane-major, loop over k")


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor,
                    inner: int = INNER) -> torch.Tensor:
    """P6 on the card (``lane_major_kernel``, then
    ``gather_rows_sum_kernel``): ``table`` (S, C) f32 or int32 (u32 bits),
    ``idx`` (R, C) int32, any values (taken mod S)."""
    if _lib.on_cpu("gather_rows_sum", table, idx):
        return gather_rows_sum_plain(table, idx, inner)
    if table.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"gather_rows_sum: table must be float32 or int32, "
                        f"got {table.dtype}")
    _lib.require("gather_rows_sum", "table", table, table.dtype, ndim=2)
    _lib.require("gather_rows_sum", "idx", idx, torch.int32, ndim=2)
    (S, C), R = table.shape, idx.shape[0]
    width = lane_major_width(S, inner)
    if idx.shape[1] != C or inner < 0 or S < 1:
        raise ValueError("gather_rows_sum: idx must have the table's "
                         f"columns, got {tuple(idx.shape)} for "
                         f"{tuple(table.shape)}, inner {inner}")
    if width >= 2 ** 31:
        raise ValueError("gather_rows_sum: the kernel indexes a lane's row "
                         "with 32-bit ints")
    lm = torch.empty((C, width), dtype=table.dtype, device=table.device)
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    _lib.launch("sf_probe_gather_rows_sum", "gather_rows_sum_kernel",
                table.device, table, idx, lm, width, out, S, C, R, inner,
                int(table.dtype == torch.int32))
    gather_rows_sum.launches += 1
    return out


def take_lanes_route(table: torch.Tensor, idx: torch.Tensor) -> str:
    """The form the lane take of the (R, C) ``table`` at ``idx`` takes on
    the card: a warp a row, the row staged in shared memory, for 128 lanes
    with the table and the index at 16-byte-aligned addresses (the output
    always is), a loop over the lanes for anything else."""
    return ("warp per row" if table.shape[-1] == 128
            and table.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
            else "lane loop")


def take_lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P7 on the card (``take_lanes128_kernel`` or ``take_lanes_kernel``,
    as ``take_lanes_route`` names): ``table`` (R, C) f32, ``idx`` (R, C)
    int32, any values (taken mod C)."""
    if _lib.on_cpu("take_lanes", table, idx):
        return take_lanes_plain(table, idx)
    _lib.require("take_lanes", "table", table, torch.float32, ndim=2)
    _lib.require("take_lanes", "idx", idx, torch.int32, table.shape)
    out = torch.empty_like(table)
    _lib.launch("sf_probe_take_lanes", "take_lanes_kernel", table.device,
                table, idx, out, table.shape[1], table.numel())
    take_lanes.launches += 1
    return out


_WRAPPERS = (gather_rows_sum, take_lanes)


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


def probe(S: int, dtype, dev, inner: int = INNER):
    """The tool's ``probe`` at S table rows: one table replicated across
    the 128 lanes (row s holds s / 2, truncated for u32), random rows."""
    tab1 = torch.arange(S, dtype=torch.float32, device=dev) * 0.5
    table = tab1[:, None].expand(S, 128).to(dtype).contiguous()
    idx = torch.randint(0, S, (S, 128), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    _lib.check_equal(f"gather_rows_sum S={S}",
                     gather_rows_sum(table, idx, inner),
                     gather_rows_sum_plain(table, idx, inner))
    ms = _lib.device_ms(lambda: gather_rows_sum(table, idx, inner), dev)
    n = S * 128 * inner
    name = "u32" if dtype == torch.int32 else "float32"
    rate = ("" if ms is None else f" ({n / ms / 1e6:.2f} G/s)")
    print(f"  S={S:6d} axis=0 {name}: "
          f"{_lib.fmt(_lib.ns_per(ms, n), '.3f', ' ns/elem')}{rate}",
          flush=True)


def probe_axis1(dev):
    """The tool's ``probe_axis1``: a (128, 128) table, lanes looked up per
    row, checked against numpy."""
    tab = np.random.RandomState(0).rand(128, 128).astype(np.float32)
    idx = np.random.RandomState(1).randint(0, 128, (128, 128))
    table = torch.as_tensor(tab, device=dev)
    index = torch.as_tensor(idx, dtype=torch.int32, device=dev)
    got = take_lanes(table, index).cpu().numpy()
    if not np.array_equal(got, np.take_along_axis(tab, idx, axis=1)):
        raise RuntimeError("take_lanes disagrees with numpy")
    ms = _lib.device_ms(lambda: take_lanes(table, index), dev)
    print(f"  axis=1 (128,128) [{take_lanes_route(table, index)}]: works, "
          f"{_lib.fmt(_lib.ns_per(ms, 128 * 128), '.3f', ' ns/elem')}",
          flush=True)


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)
    print(f"== gather-sum along rows (axis=0, per-lane table, {INNER} terms; "
          f"{rows_sum_route(INNER)}) ==", flush=True)
    for S in (8, 64, 512, 4096, 8192, 32768):
        probe(S, torch.float32, dev)
    print("== axis=0, u32 (int32 bits, wrapping add) ==", flush=True)
    probe(8192, torch.int32, dev)
    print("== axis=1 (per-row lane lookup) ==", flush=True)
    probe_axis1(dev)
    print("done", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
