"""Random access on the card: gathers from and scatter-adds into on-chip
memory, and a box read at a dynamic start (P2-P5).

Port of ``tools/probe_random_access.py``. Its Pallas kernels become:

| wrapper     | TPU probe kernel (tools/probe_random_access.py)   |
| ----------- | ------------------------------------------------- |
| gather_smem | probe_pallas_scalar_gather :89 (body :94)         |
| take        | probe_pallas_vector_take :123 (body :128)         |
| scatter_add | probe_pallas_scalar_rmw :157 (body :162)          |
| box_sum     | probe_box_dma :194 (body :200)                    |

Shared memory takes the place of VMEM: ``gather_smem`` stages the table
there with the TMA's bulk copy, and ``scatter_add`` accumulates in the
distributed shared memory of one thread-block cluster; ``box_sum`` reads
its box with the TMA's 3-D tile load where it can (``box_route``).
``take`` gathers
from shared memory where the table fits (up to 227 KB less 32 B) and
from device memory otherwise (``take_route``). The tool's parts that were
no Pallas stay plain PyTorch timings: part 1 ``torch.take``, part 2
``index_add_``, part 7 a one-hot ``torch.matmul``. Times are device
times of 20 calls replayed from one CUDA graph (``_lib.device_ms``) with
fixed indices, where the tool rotated its indices inside one program.

    python -m segfusion_tpu_torch.probes.random_access [--device cpu]
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import _lib

__all__ = ["gather_smem", "take", "scatter_add", "box_sum", "gather_plain",
           "scatter_add_plain", "box_sum_plain", "take_route", "box_route",
           "BOX_UNROLLED",
           "GATHER_SMEM_MAX_BYTES",
           "scatter_add_max_bins", "SCATTER_CLUSTER", "main",
           "launch_counts", "reset_launch_counts"]


# -- plain versions -----------------------------------------------------------

def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table.flatten()[idx[i]], shaped like ``idx``."""
    return torch.take(table, idx.long())


def scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, n_out: int
                      ) -> torch.Tensor:
    """(n_out,) f32: zeros, then upd[i] added at idx[i]."""
    out = torch.zeros(n_out, dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.reshape(-1).long(), upd.reshape(-1))


def box_sum_plain(vol: torch.Tensor, pos: torch.Tensor, box: int
                  ) -> torch.Tensor:
    """(box, box): the box^3 box of ``vol`` at ``pos`` (clamped into the
    volume, as lax.dynamic_slice clamps) summed over x, in order of x."""
    start = [min(max(int(p), 0), s - box)
             for p, s in zip(pos.tolist(), vol.shape)]
    x0, y0, z0 = start
    acc = torch.zeros((box, box), dtype=vol.dtype, device=vol.device)
    for x in range(box):
        acc += vol[x0 + x, y0:y0 + box, z0:z0 + box]
    return acc


# -- wrappers -----------------------------------------------------------------

def _check_gather(name, table, idx):
    _lib.require(name, "table", table, torch.float32)
    _lib.require(name, "idx", idx, torch.int32)


# the largest table the shared route takes: its shared memory also holds
# a 16-byte slot for the bulk copy's mbarrier and up to 12 bytes that keep
# the table at its device-memory phase modulo 16
GATHER_SMEM_MAX_BYTES = _lib.SMEM_BYTES - 32


def take_route(table: torch.Tensor) -> str:
    """Where ``take`` gathers ``table`` from on the card."""
    return ("shared memory" if table.numel() * 4 <= GATHER_SMEM_MAX_BYTES
            else "device memory (L2)")


def _launch_gather(table, idx, smem: bool):
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    launcher, kernel = (("sf_probe_gather_smem", "gather_smem_kernel")
                        if smem else
                        ("sf_probe_gather_global", "gather_global_kernel"))
    _lib.launch(launcher, kernel, idx.device, table, table.numel(), idx, out,
                idx.numel())
    return out


def gather_smem(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: out[i] = table[idx[i]] with the table staged in shared memory
    by the TMA's bulk copy (at most ``GATHER_SMEM_MAX_BYTES``, any
    alignment); ``idx`` int32 in [0, table.numel())."""
    if _lib.on_cpu("gather_smem", table, idx):
        return gather_plain(table, idx)
    _check_gather("gather_smem", table, idx)
    if table.numel() * 4 > GATHER_SMEM_MAX_BYTES:
        raise ValueError(f"gather_smem: a {table.numel() * 4} B table does "
                         f"not fit in shared memory (at most "
                         f"{GATHER_SMEM_MAX_BYTES} B)")
    out = _launch_gather(table, idx, smem=True)
    gather_smem.launches += 1
    return out


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P3: the same gather in the TPU's vector form; from shared memory
    where the table fits, from device memory where it does not."""
    if _lib.on_cpu("take", table, idx):
        return gather_plain(table, idx)
    _check_gather("take", table, idx)
    out = _launch_gather(table, idx,
                         smem=take_route(table) == "shared memory")
    take.launches += 1
    return out


def _take_device_memory(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """``take``'s device-memory kernel on any table, a shared-route one
    too: a measurement of the two routes on one table, which ``take``
    itself never makes (its route is ``take_route``'s). Not counted in
    ``take.launches``."""
    if _lib.on_cpu("take", table, idx):
        return gather_plain(table, idx)
    _check_gather("take", table, idx)
    return _launch_gather(table, idx, smem=False)


# P4's thread-block cluster (kCluster in csrc/probes.cu): 16 blocks, each
# holding a slice of the bins, a 32 KiB stage (4 updates for each of its
# 1,024 threads, 8 bytes each) and 4 x 16 bucket counts and starts in its
# shared memory
SCATTER_CLUSTER = 16
_SCATTER_STAGE_BYTES = 1024 * 4 * 8 + 16 * 16


def scatter_add_max_bins() -> int:
    """The most f32 bins ``scatter_add`` takes: what the cluster's blocks'
    shared memory holds beside their stages, each slice a multiple of 4
    bins."""
    return SCATTER_CLUSTER * ((_lib.SMEM_BYTES - _SCATTER_STAGE_BYTES)
                              // 16 * 4)


def scatter_add(idx: torch.Tensor, upd: torch.Tensor, n_out: int
                ) -> torch.Tensor:
    """P4: (n_out,) f32 = 0, then upd[i] added at idx[i] (int32 in
    [0, n_out)), accumulated in the distributed shared memory of one
    thread-block cluster (n_out at most ``scatter_add_max_bins()``). The
    order of the adds is not fixed."""
    if _lib.on_cpu("scatter_add", idx, upd):
        return scatter_add_plain(idx, upd, n_out)
    _lib.require("scatter_add", "idx", idx, torch.int32)
    _lib.require("scatter_add", "upd", upd, torch.float32, idx.shape)
    if not 0 < n_out <= scatter_add_max_bins():
        raise ValueError(f"scatter_add: {n_out} f32 bins do not fit in the "
                         f"shared memory of a {SCATTER_CLUSTER}-block "
                         f"cluster (at most {scatter_add_max_bins()})")
    out = torch.empty(n_out, dtype=torch.float32, device=idx.device)
    _lib.launch("sf_probe_scatter_add", "scatter_add_kernel", idx.device,
                idx, upd, idx.numel(), out, n_out)
    scatter_add.launches += 1
    return out


# the box side box_sum's kernels are built for (kBoxUnrolled in
# csrc/probes.cu): the probe's
BOX_UNROLLED = 64


def box_route(vol: torch.Tensor, start, box: int) -> str:
    """The form ``box_sum``'s kernel takes on the card for ``vol`` and the
    (host) ``start``: at the probe's box of 64, the TMA's 3-D tile load
    where the volume's rows are whole 16-byte units at a 16-byte-aligned
    address (the tensor map needs both) and the clamped start's z is
    16-byte aligned (the copy needs it), else 64 thread loads a column
    unrolled; a loop over x at any other size."""
    if box != BOX_UNROLLED:
        return "x loop"
    z0 = min(max(int(start[2]), 0), vol.shape[-1] - box)
    if vol.shape[-1] % 4 == 0 and vol.data_ptr() % 16 == 0 and z0 % 4 == 0:
        return "tma tile"
    return "unrolled"


def box_sum(vol: torch.Tensor, pos: torch.Tensor, box: int) -> torch.Tensor:
    """P5: the box^3 box of the (SX, SY, SZ) f32 ``vol`` at ``pos`` ((3,)
    int32, read on the device, clamped into the volume) summed over x."""
    if _lib.on_cpu("box_sum", vol, pos):
        return box_sum_plain(vol, pos, box)
    _lib.require("box_sum", "vol", vol, torch.float32, ndim=3)
    _lib.require("box_sum", "pos", pos, torch.int32, (3,))
    if not 0 < box <= min(vol.shape):
        raise ValueError(f"box_sum: box {box} does not fit in "
                         f"{tuple(vol.shape)}")
    out = torch.empty((box, box), dtype=torch.float32, device=vol.device)
    _lib.launch("sf_probe_box_sum", "box_sum_kernel", vol.device, vol,
                *vol.shape, pos, box, out)
    box_sum.launches += 1
    return out


_WRAPPERS = (gather_smem, take, scatter_add, box_sum)


def reset_launch_counts():
    _lib.reset(_WRAPPERS)


def launch_counts() -> dict:
    return _lib.counts(_WRAPPERS)


reset_launch_counts()


# -- the probe ----------------------------------------------------------------

def _ns(ms, n):
    return _lib.fmt(_lib.ns_per(ms, n), ".3f", " ns/elem")


def main(device="cuda"):
    dev = resolve_device(device)
    print(_lib.device_line(dev), flush=True)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    n_idx = 1 << 20
    sides = (32, 64, 128, 256)
    print("== 1. flat scalar gather, torch.take ==", flush=True)
    for side in sides:
        nvox = side ** 3
        table = torch.ones(nvox, device=dev)
        idx = torch.randint(0, nvox, (n_idx,), generator=gen(0), device=dev)
        ms = _lib.device_ms(lambda: torch.take(table, idx), dev)
        print(f"  table {side}^3 ({nvox * 4 / 2 ** 20:.1f} MiB): "
              f"{_ns(ms, n_idx)}", flush=True)

    print("== 2. flat scatter-add, index_add_ ==", flush=True)
    for side in sides:
        nvox = side ** 3
        vol = torch.zeros(nvox, device=dev)
        idx = torch.randint(0, nvox, (n_idx,), generator=gen(1), device=dev)
        upd = torch.ones(n_idx, device=dev)
        ms = _lib.device_ms(lambda: vol.index_add_(0, idx, upd), dev)
        print(f"  table {side}^3 ({nvox * 4 / 2 ** 20:.1f} MiB): "
              f"{_ns(ms, n_idx)}", flush=True)

    nvox, n = 32 ** 3, 1 << 16
    print("== 3. scalar gather from shared memory (P2 gather_smem) ==",
          flush=True)
    table = torch.ones((1, nvox), device=dev)
    idx = torch.randint(0, nvox, (1, n), generator=gen(2), device=dev,
                        dtype=torch.int32)
    _lib.check_equal("gather_smem", gather_smem(table, idx),
                     gather_plain(table, idx))
    ms = _lib.device_ms(lambda: gather_smem(table, idx), dev)
    print(f"  table 32^3 ({nvox * 4 // 1024} KiB): {_ns(ms, n)}", flush=True)

    print("== 4. vector gather (P3 take) ==", flush=True)
    for size in (512, 32 ** 3, 64 ** 3):
        table = torch.ones((1, size), device=dev)
        idx = torch.randint(0, size, (n // 128, 128), generator=gen(3),
                            device=dev, dtype=torch.int32)
        _lib.check_equal("take", take(table, idx), gather_plain(table, idx))
        ms = _lib.device_ms(lambda: take(table, idx), dev)
        print(f"  table {size} ({take_route(table)}): {_ns(ms, n)}",
              flush=True)

    print("== 5. scatter-add into a cluster's shared memory "
          "(P4 scatter_add) ==", flush=True)
    idx = torch.randint(0, nvox, (1, n), generator=gen(4), device=dev,
                        dtype=torch.int32)
    upd = torch.ones((1, n), device=dev)
    _lib.check_equal("scatter_add", scatter_add(idx, upd, nvox),
                     scatter_add_plain(idx, upd, nvox))
    ms = _lib.device_ms(lambda: scatter_add(idx, upd, nvox), dev)
    print(f"  32^3 bins, {n} all-one updates: {_ns(ms, n)}", flush=True)

    print("== 6. dynamic-start 3-D box sum (P5 box_sum) ==", flush=True)
    side, box = 256, 64
    vol = torch.ones((side, side, side), device=dev)
    pos = torch.tensor([8, 16, 32], dtype=torch.int32, device=dev)
    _lib.check_equal("box_sum", box_sum(vol, pos, box),
                     box_sum_plain(vol, pos, box))
    ms = _lib.device_ms(lambda: box_sum(vol, pos, box), dev)
    if ms is None:
        print(f"  {box}^3 box: {_lib.fmt(ms)}", flush=True)
    else:
        print(f"  {box}^3 box: {ms * 1e3:.2f} us/box, "
              f"{box ** 3 * 4 / ms / 1e6:.1f} GB/s", flush=True)

    print("== 7. one-hot matmul gather (torch.matmul, bf16) ==", flush=True)
    rows, width = 2048, 512
    idx = torch.randint(0, width, (rows,), generator=gen(5), device=dev)
    table = torch.ones((width, 128), dtype=torch.bfloat16, device=dev)
    cols = torch.arange(width, device=dev)

    def onehot():
        oh = (idx[:, None] == cols[None, :]).to(torch.bfloat16)
        return torch.matmul(oh, table)

    ms = _lib.device_ms(onehot, dev)
    if ms is None:
        print(f"  E={rows} V={width}: {_lib.fmt(ms)}", flush=True)
    else:
        print(f"  E={rows} V={width}: {ms * 1e6 / rows:.1f} ns/gather-row "
              f"({2 * rows * width * 128 / ms / 1e9:.3f} TFLOP/s)",
              flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    _lib.run_cli(main, __doc__)
