"""One run of one cell: build the port's pipeline from the cell's
configuration file, make its weights and frames from the seed, warm up,
drive the cell's traffic for the window, then check the result against
the plain reference.

Everything a cell is made of is data the harness finds by name:
``configs/<config>.json`` (the yaml section the port reads, and the sizes
assumed), ``traffic/<traffic>.json`` (the loop and its parameters),
``limits/<cell>.json`` (the limit of each number compared),
``metrics/<metric>.py`` (one reader per per-layer metric) and
``nets/<kind>/<name>.py`` (how each net is built in the port, and its
plain reference: ``architectures``).
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import architectures, check, scene, spans, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OVERRIDES = ("SEGFUSION_FRAME_BLOCK", "SEGFUSION_GEO_DTYPE")
FORBIDDEN = ("jax", "jaxlib", "flax", "segfusion_tpu")

__all__ = ["Cell", "load_cell", "refuse_overrides", "forbidden_modules",
           "build", "run_window", "traces_window", "device_window",
           "end_to_end", "result_line"]


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry of BENCHMARK.json with its configuration, traffic
    and limits files."""

    def __init__(self, entry: dict, bench: dict, config: dict, traffic: dict,
                 limits: Optional[dict]):
        self.entry, self.bench = entry, bench
        self.name = entry["name"]
        self.config, self.traffic, self.limits = config, traffic, limits

    def metrics(self, kind: str) -> List[dict]:
        """The cell's end_to_end or per_layer metrics: those listing it,
        and those without a list that move (or are) a metric it reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in names]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits = HERE / "limits" / f"{name}.json"
    return Cell(entry, bench, _json(root / conf["file"]),
                _json(HERE / "traffic" / f"{entry['traffic']}.json"),
                _json(limits) if limits.exists() else None)


def refuse_overrides(environ=os.environ) -> Optional[str]:
    """The environment variables that would make the port run other
    settings than a cell's file states (``core/pipeline.py`` reads them
    over the config), or None."""
    found = [k for k in OVERRIDES if environ.get(k)]
    return ", ".join(found) if found else None


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``segfusion_tpu_torch`` is not
    ``segfusion_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def port_config(conf: dict):
    from segfusion_tpu_torch.config import Config, with_defaults
    return with_defaults(Config(copy.deepcopy(conf["config"])))


class Run:
    """The port's objects of one run and the inputs they are given."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.cfg = port_config(cell.config)
        self.assumed = cell.config["assumed"]
        self.order: List[int] = []          # orbit index of each frame fused


def build(cell: Cell, seed: int, device) -> Run:
    """Weights, the pipeline, the orbit's frames and an empty stream. The
    nets' files are found by name first (``architectures``): an unknown
    name stops the run before anything is built."""
    run = Run(cell, seed, device)
    cfg, dev = run.cfg, run.device
    fusion_file = architectures.fusion(cell.config["config"])
    labels = bool(cfg.DATA.get("semantics")) and \
        cfg.DATA.semantic_strategy == "predict"
    seg_file = (architectures.segmenter(cell.config["config"]) if labels
                else None)
    from segfusion_tpu_torch.core.pipeline import Pipeline

    with torch.device("meta"):
        fnet = fusion_file.port(cfg.FUSION_MODEL)
    run.fusion_state = weights.random_state(
        fnet, weights.generator(seed, 1, dev), dev)
    fnet.load_state_dict(run.fusion_state, assign=True)
    segmenter, run.seg_state = None, None
    if seg_file is not None:
        with torch.device("meta"):
            snet = seg_file.port(cfg.SEMANTIC_2D_MODEL)
        dtype = (torch.bfloat16 if cfg.SEMANTIC_2D_MODEL.get("compute_dtype")
                 in ("bfloat16", "bf16") else torch.float32)
        run.seg_state = weights.random_state(
            snet, weights.generator(seed, 2, dev), dev, dtype)
        snet.load_state_dict(run.seg_state, assign=True)
        segmenter = seg_file.pipeline_segmenter(snet.eval())
    run.pipe = Pipeline(cfg, segmenter=segmenter, fusion_net=fnet,
                        device=dev)
    t = cell.traffic
    run.orbit = scene.render_orbit(
        scene.Room(int(t["room_seed"]), float(t["room_half"])),
        int(t["orbit_poses"]),
        int(cfg.DATA.resy), int(cfg.DATA.resx), dev,
        weights.generator(seed, 3, dev), float(t["noise_sigma"]))
    run.stream = new_stream(run)
    return run


def new_stream(run: Run):
    from segfusion_tpu_torch.core.volume import init_scene_volume
    from segfusion_tpu_torch.ops import rowvol
    a = run.assumed
    vol = init_scene_volume(tuple(a["volume_shape"]), a["volume_origin"],
                            float(a["voxel_size"]),
                            float(run.cfg.DATA.init_value), run.device)
    run.layout = rowvol.RowLayout.for_shape(tuple(a["volume_shape"]))
    return run.pipe._new_stream(run.layout,
                                run.pipe._enter_rows(run.layout, vol))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chunk_size(run: Run) -> int:
    c = run.cell.traffic.get("chunk", 1)
    return int(run.cfg.TESTING.sequence_chunk) if c == "sequence_chunk" \
        else int(c)


def _frames(run: Run, start: int, n: int):
    P = int(run.cell.traffic["orbit_poses"])
    s = start % P
    return {k: v[s:s + n] for k, v in run.orbit.items()}, \
        [(start + i) % P for i in range(n)]


def fuse(run: Run, start: int, n: int) -> None:
    """Hand frames start .. start+n-1 of the cycled orbit to the port."""
    frames, idx = _frames(run, start, n)
    run.stream = run.pipe.fuse_sequence_rows(run.layout, run.stream, frames)
    run.order.extend(idx)


def warm_up(run: Run) -> None:
    """The cell's shapes through the timed call, on a stream that is then
    dropped: two units of the traffic (chunks, or single frames)."""
    n = chunk_size(run)
    for i in range(2):
        fuse(run, i * n, n)
    _sync(run.device)
    run.order.clear()
    run.stream = None
    run.stream = new_stream(run)
    _sync(run.device)


def run_window(run: Run, seconds: float, limit_units: Optional[int] = None
               ) -> Dict[str, float]:
    """Drive the traffic for ``seconds`` (or ``limit_units`` units) and
    return what the host clock read."""
    loop = run.cell.traffic["loop"]
    n = chunk_size(run)
    dev = run.device
    start = len(run.order)
    if loop == "stream":                   # closed loop: chunk after chunk
        t0 = time.perf_counter()
        deadline = t0 + seconds
        units = 0
        while (time.perf_counter() < deadline if limit_units is None
               else units < limit_units):
            fuse(run, start + units * n, n)
            units += 1
        _sync(dev)
        wall = time.perf_counter() - t0
        frames = units * n
        return {"frames": frames, "wall_s": wall, "fps": frames / wall}
    if loop == "live":                     # open loop: one frame when due
        rate = float(run.cell.traffic["rate_fps"])
        period = 1.0 / rate
        lat, service, late = [], [], []
        t0 = time.perf_counter()
        i, done = 0, t0
        while True:
            due = t0 + i * period
            if (due >= t0 + seconds if limit_units is None
                    else i >= limit_units):
                break
            # wait on the clock itself, not in a sleep: on a shared host a
            # sleep woke up to 20 ms late, and that lateness counted as
            # the port's latency
            while time.perf_counter() < due:
                pass
            begin = time.perf_counter()
            if done <= due:            # the generator's own lateness
                late.append(begin - due)
            fuse(run, start + i, 1)
            _sync(dev)
            done = time.perf_counter()
            lat.append(done - due)
            service.append(done - begin)
            i += 1
        wall = time.perf_counter() - t0
        return {"frames": i, "wall_s": wall, "fps": i / wall,
                "latency_s": lat, "service_s": service, "late_s": late}
    raise SystemExit(f"unknown traffic loop {loop!r}")


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=20)[-1]


def traces_window(run: Run) -> bool:
    """Whether the cell reports an end-to-end metric read off the device,
    so that its ``--trace 0`` window runs under a device-only trace."""
    return run.device.type == "cuda" and any(
        m["source"] == "device_trace" for m in run.cell.metrics("end_to_end"))


def device_window(run: Run, seconds: float) -> Dict[str, float]:
    """The window of a ``--trace 0`` run: where ``traces_window``, the
    whole window under a device-only trace (no host events), whose busy
    seconds join what the window read."""
    if not traces_window(run):
        return run_window(run, seconds)
    prof, window = spans.profile(lambda: run_window(run, seconds),
                                 run.device, host=False)
    window["busy_s"] = spans.busy_seconds(prof)
    return window


def end_to_end(run: Run, window: dict, setup_s: float) -> Dict[str, float]:
    """The host clock's and the device trace's readings over the window,
    those the cell reports."""
    out = {"setup_s": setup_s, "fuse_fps": window["fps"]}
    if "latency_s" in window:
        out["frame_p95_ms"] = 1e3 * p95(window["latency_s"])
    if window.get("busy_s"):
        out["device_ms_per_frame"] = 1e3 * window["busy_s"] / window["frames"]
    names = {m["name"] for m in run.cell.metrics("end_to_end")}
    return {k: v for k, v in out.items() if k in names}


def per_layer(run: Run, trace: dict) -> Dict[str, float]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    import importlib.util
    out = {}
    for m in run.cell.metrics("per_layer"):
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(trace)
        if v is not None:
            out[m["name"]] = float(v)
    return out


def k1_bytes(run: Run, start: int, frames: int, carry) -> float:
    """K1's bytes over frames ``start`` .. ``start + frames - 1`` of the
    traffic, handed to the port again one block at a time: before each
    block, the share of the tiles its dirty carry marks (``carry`` for the
    first block, ``RowStream.dirty`` after) times the geo and shadow bytes
    (``chip_smoke.py``'s accounting); a block without a carry rebuilds
    every tile. The blocks are those of the stretch's chunks, so each K1
    call is counted with the mask it was given there."""
    lay = run.layout
    per_call = (lay.geo_rows * 128 * run.pipe.geo_dtype.itemsize
                + lay.shadow_rows * 128 * 4)
    n, kb = chunk_size(run), run.pipe.frame_block
    total = 0.0
    for c in range(start, start + frames, n):
        for b in range(c, min(c + n, start + frames), kb):
            dirty = carry if b == start else run.stream.dirty
            share = 1.0 if dirty is None else float(
                dirty[:-1].float().mean())
            total += share * per_call
            fuse(run, b, min(kb, c + n - b))
    return total


def traced_stretch(run: Run, units: int) -> dict:
    """``units`` more units of the traffic traced on the device alone (its
    busy seconds, the kernels by time, K1's device time), the same frames
    again to count K1's bytes, then ``units`` more under the port's
    labelled spans and the host's profiler (launches, device ms and idle
    gaps by span; the host's tracing slows the host, so they are read
    apart)."""
    from segfusion_tpu_torch.utils import tracing
    start = len(run.order)
    carry = None if run.stream.dirty is None else run.stream.dirty.clone()
    prof, window = spans.profile(lambda: run_window(run, 0.0, units),
                                 run.device, host=False)
    device = spans.device_readings(prof, window)
    kernels = device.pop("kernels")
    k1 = {"device_s": device.pop("k1_device_s"),
          "bytes": k1_bytes(run, start, window["frames"], carry)}
    with tracing.enabled(labels=True) as tr:
        lprof, _ = spans.profile(lambda: run_window(run, 0.0, units),
                                 run.device, host=True)
    reduction = tracing.reduce_profile(lprof)
    return dict(device, k1=k1,
                labelled=spans.labelled_readings(reduction,
                                                 tr.counters["frames"]),
                breakdown={
                    "device_ops": [[n, s] for n, s in
                                   kernels.most_common(10)],
                    "idle_gaps": spans.idle_gaps(reduction)})


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, float], units: Dict[str, str],
                device: dict, checks: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def device_info(dev, count: int = 1) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print) -> dict:
    """The whole run; returns the parts of the result line."""
    dev = torch.device(device)
    run = build(cell, seed, dev)
    warm_up(run)
    if not trace and traces_window(run):
        # the device trace's start-up, out of the window
        spans.profile(lambda: run_window(run, 0.0, 1), dev, host=False)
        run.order.clear()
        run.stream = None
        run.stream = new_stream(run)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    trace_data = None
    if trace:
        from segfusion_tpu_torch.utils import tracing
        with tracing.enabled() as tr:
            window = run_window(run, seconds)
        # the stretches' shapes and the profiler's start-up, after the
        # window: a profiler session slows the host's later launches
        traced_stretch(run, 1)
        stretch = traced_stretch(run, int(cell.traffic["profile_units"]))
        trace_data = dict(stretch, host=spans.host_readings(tr),
                          window_fps=window["fps"],
                          service_ms=[1e3 * s for s in
                                      window.get("service_s", [])],
                          flops_per_frame=check.flops_per_frame(run))
    else:
        window = device_window(run, seconds)
    if "late_s" in window:
        late = window["late_s"] or [0.0]
        log(f"live: {window['frames']} frames due at "
            f"{cell.traffic['rate_fps']} frames/s; the generator handed a "
            f"frame in late by at most {1e3 * max(late):.3f} ms (frames that "
            f"found the port idle); {window['frames'] - len(window['late_s'])}"
            f" frames waited for the one before; p50 "
            f"service {1e3 * statistics.median(window['service_s']):.3f} ms",
            file=sys.stderr)
    dinfo = device_info(dev)
    result = {"window": window, "setup_s": setup_s, "device": dinfo,
              "attempted": len(run.order)}
    if trace:
        result["metrics"] = per_layer(run, trace_data)
        dinfo["busy_s"] = trace_data["busy_s"]
        dinfo["window_s"] = trace_data["wall_s"]
        result["breakdown"] = trace_data["breakdown"]
    else:
        result["metrics"] = end_to_end(run, window, setup_s)
    final = run.pipe._exit_rows(run.layout, run.stream.rv)
    result["numbers"] = check.compare_run(run, final)
    return result


def judge(numbers: Dict[str, float], limits: Optional[dict]):
    """(correct, checks): every limited number at or under its limit; no
    limits file, no correct run."""
    if not limits:
        return False, {k: {"value": v, "limit": None}
                       for k, v in numbers.items()}
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits["limits"].items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
