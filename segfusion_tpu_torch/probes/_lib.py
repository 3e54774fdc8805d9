"""What the probe modules share: the CUDA library of ``csrc/probes.cu``,
the launch and the argument checks of its wrappers, their launch counters,
device timing and the launch floor.

``csrc/probes.cu`` is built with nvcc for sm_90a at first use
(``ops/kernels/_build``) and loaded with ctypes. A wrapper takes its plain
version only for a tensor on the CPU; for a CUDA tensor it checks what the
kernel takes, launches it (raising where the launch fails) and adds one to
its count, ``<wrapper>.launches``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import torch

from ..ops.kernels import _build

# H100 SXM: device memory rate, and the most dynamic shared memory one
# block can have (the opt-in limit)
HBM_BYTES_PER_S = 3.35e12
SMEM_BYTES = 232448

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# launcher -> argument types after the pointers' and sizes' order in
# csrc/probes.cu; every launcher ends with the stream and returns an int
_SIGNATURES = {
    "sf_probe_dma_only": [_P, _P, _I, _I, _I, _I, _I],
    "sf_probe_gather_smem": [_P, _I, _P, _P, _L],
    "sf_probe_gather_global": [_P, _I, _P, _P, _L],
    "sf_probe_scatter_add": [_P, _P, _L, _P, _I],
    "sf_probe_box_sum": [_P, _I, _I, _I, _P, _I, _P],
    "sf_probe_gather_rows_sum": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I],
    "sf_probe_take_lanes": [_P, _P, _P, _I, _L],
    "sf_probe_f16_pack": [_P, _P, _L],
    "sf_probe_lane_swap": [_P, _P, _I, _L],
    "sf_probe_roll_lanes": [_P, _P, _I, _I, _L],
    "sf_probe_reshape_slices": [_P, _P, _L],
    "sf_probe_qshift": [_P, _P, _I, _L],
    "sf_probe_iota_mask": [_P, _P, _I, _L],
    "sf_probe_f16_unpack": [_P, _P, _L],
    "sf_probe_store16": [_P, _P, _I, _L],
    "sf_probe_rolls_sum": [_P, _P, _I, _L],
    "sf_probe_narrow_pad": [_P, _P, _I, _L],
    "sf_probe_regroup": [_P, _P, _I, _L],
    "sf_probe_offset_copy": [_P, _P, _I, _I],
    "sf_probe_window_copy": [_P, _I, _I, _P, _I, _I, _I, _P, _I],
    "sf_probe_noop": [],
}


@functools.lru_cache(maxsize=None)
def library():
    """``csrc/probes.cu``, built at first use, with its signatures."""
    lib, _ = _build.load_library("probes")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, _P]
        fn.restype = _I
    return lib


def launch(launcher: str, kernel: str, device, *args):
    """Call ``launcher`` with ``args`` (tensors as their data pointers) and
    the current stream of ``device``; raises where the launch failed."""
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(library(), launcher)(
        *raw, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True where the tensors lie on the CPU (the wrapper then takes its
    plain version), False where they all lie on one CUDA device; raises
    on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cpu"


def require(name: str, what: str, t: torch.Tensor, dtype, shape=None,
            ndim=None):
    """Raise unless ``t`` is contiguous, of ``dtype`` and, where given, of
    ``shape`` / ``ndim`` dimensions."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {what} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")


def lanes(name: str, x: torch.Tensor, min_c: int = 1,
          row_multiple: int = 1, c=None):
    """Check a contiguous 2-D f32 (R, C) input of a lane kernel; (R, C)."""
    require(name, "x", x, torch.float32, ndim=2)
    R, C = x.shape
    if C < min_c or R % row_multiple or (c is not None and C != c):
        raise ValueError(f"{name}: the kernel does not take shape "
                         f"{tuple(x.shape)}")
    return R, C


def lane_kernel(wrapper, plain, launcher: str, x: torch.Tensor,
                extra=(), pass_c: bool = True, out_dtype=torch.float32,
                **shape):
    """The body of a lane kernel's wrapper: ``plain(x)`` on the CPU; on
    the card check the (R, C) f32 ``x`` (``shape``: see ``lanes``), launch
    ``launcher`` on (x, out, [C,] *extra, R * C) and count the launch."""
    name = wrapper.__name__
    if on_cpu(name, x):
        return plain(x)
    _, C = lanes(name, x, **shape)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    sizes = (C, *extra) if pass_c else tuple(extra)
    launch(launcher, f"{launcher[len('sf_probe_'):]}_kernel", x.device, x,
           out, *sizes, x.numel())
    wrapper.launches += 1
    return out


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor):
    """Raise unless the kernel's result equals its plain version's, bit for
    bit."""
    if got.dtype != want.dtype or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() \
            if got.shape == want.shape else "shape"
        raise RuntimeError(f"{name}: the kernel disagrees with its plain "
                           f"version (max |diff| {diff})")


def ns_per(ms, n: int):
    """Nanoseconds per element from milliseconds per call (None stays)."""
    return None if ms is None else ms * 1e6 / n


def reset(wrappers):
    for fn in wrappers:
        fn.launches = 0


def counts(wrappers) -> dict:
    return {fn.__name__: fn.launches for fn in wrappers}


def device_times(fn, device, iters: int = 20, replays: int = 1):
    """Device milliseconds per call of ``fn`` on a CUDA device, one value
    per replay: ``iters`` calls captured in one CUDA graph (after two
    warm-up calls), the graph replayed once untimed and then ``replays``
    times, each replay between its own CUDA events, so the host's launch
    overhead between the calls drops out, as the TPU probes amortised
    theirs inside one program. ``fn`` must be capturable (no host
    synchronisation). On the CPU ``fn`` runs once and the result is None:
    a host clock does not time the card."""
    device = torch.device(device)
    if device.type != "cuda":
        fn()
        return None
    fn()
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(replays + 1)]
    events[0].record()
    for e in events[1:]:
        graph.replay()
        e.record()
    torch.cuda.synchronize(device)
    del graph
    return [a.elapsed_time(b) / iters for a, b in zip(events, events[1:])]


def device_ms(fn, device, iters: int = 20, replays: int = 1):
    """The median of ``device_times`` (None on the CPU)."""
    times = device_times(fn, device, iters, replays)
    return None if times is None else sorted(times)[len(times) // 2]


def noop(device):
    """Launch the empty kernel of ``csrc/probes.cu`` on ``device``'s
    current stream: its time is the launch floor every kernel pays."""
    launch("sf_probe_noop", "noop_kernel", device)


def fmt(value, spec: str = ".4f", unit: str = "") -> str:
    """``value`` formatted, or "not measured (cpu)" for None."""
    return "not measured (cpu)" if value is None else f"{value:{spec}}{unit}"


def device_line(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return (f"device: {torch.cuda.get_device_name(device)} "
                f"(count {torch.cuda.device_count()})")
    return "device: cpu (plain versions; no times)"


def run_cli(main, doc: str):
    """``python -m`` entry of a probe module: ``main(--device)``."""
    parser = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: cuda; cpu runs the "
                             "plain versions and prints no times)")
    main(parser.parse_args().device)
