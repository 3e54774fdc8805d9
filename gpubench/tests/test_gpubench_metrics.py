"""The per-layer readers and the trace arithmetic on hand-built traces."""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from gpubench import harness, spans
from segfusion_tpu_torch.utils import tracing

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRACE = {"wall_s": 2.0, "busy_s": 1.5, "frames": 64,
         "flops_per_frame": 1e11,
         "window_fps": 21.5,
         "k1": {"device_s": 0.01, "bytes": 0.5 * 3.35e10},
         "service_ms": [30.0, 10.0, 20.0],
         "host": {"frames": 100,
                  "spans": {"chunk": 2000.0, "block": 1500.0,
                            "fusionnet": 300.0, "fusionnet.replay": 40.0,
                            "rowops.front": 30.0, "rowops.extract": 20.0,
                            "k1": 5.0},
                  "chunk_ms": [12.0, 11.0, 40.0, 10.0],
                  "counters": {"frames": 100, "chunks": 4,
                               "fusionnet.replays": 90,
                               "fusionnet.eager": 6,
                               "fusionnet.captures": 2,
                               "rowops.replays": 3, "rowops.eager": 1}},
         "labelled": {"frames": 50, "launches": 22350, "device_ms": 700.0,
                      "spans_device_ms": {
                          "chunk": 700.0, "fusionnet": 400.0,
                          "fusionnet.replay": 399.0, "adapnet": 36.0,
                          "rowops.front": 12.5, "rowops.scatter": 100.0,
                          "k1": 30.0}}}


@pytest.mark.parametrize("name,value", [
    ("idle_share.stream", 25.0),
    ("step_mfu.stream", 100 * 1e11 * 64 / 2.0 / 989e12),
    ("launches_per_frame.stream", 447.0),
    ("fuse_fps.stream", 21.5),
    ("graph_replay_share.stream", 100 * 93 / 100),
    ("fusionnet_host_ms.stream", 3.0),
    ("fusionnet_device_ms.stream", 8.0),
    ("rowops_host_ms.stream", 0.5),
    ("rowops_device_ms.stream", 2.25),
    ("k1_roofline.stream", 50.0),
    ("service_ms_p50.live", 20.0),
    ("issue_ms_p50.live", 11.5),
    ("launches_per_frame.live", 447.0),
    ("fuse_fps.accuracy", 21.5),
    ("idle_share.accuracy", 25.0),
    ("step_mfu.accuracy", 100 * 1e11 * 64 / 2.0 / 989e12),
    ("fusionnet_device_ms.accuracy", 8.0),
    ("adapnet_device_ms.accuracy", 0.72),
    ("rowops_device_ms.accuracy", 2.25),
    ("k1_roofline.accuracy", 50.0)])
def test_reader(name, value):
    assert reader(name)(TRACE) == pytest.approx(value, rel=1e-12)


def test_every_reader_is_tested():
    tested = {p[0] for p in test_reader.pytestmark[0].args[1]}
    assert tested == {p.stem for p in METRICS.glob("*.py")
                      if not p.stem.startswith("_")}


@pytest.mark.parametrize("name", [p.stem for p in METRICS.glob("*.py")
                                  if not p.stem.startswith("_")])
def test_nothing_to_read(name):
    assert reader(name)({}) is None


@pytest.mark.parametrize("name,trace", [
    ("adapnet_device_ms.accuracy",      # a depth cell runs no AdapNet++
     dict(TRACE, labelled={"frames": 5, "launches": 9, "device_ms": 1.0,
                           "spans_device_ms": {"fusionnet": 1.0}})),
    ("rowops_device_ms.stream",         # a run with no device work
     dict(TRACE, labelled=dict(TRACE["labelled"], device_ms=0.0))),
    ("fusionnet_device_ms.accuracy",
     dict(TRACE, labelled=dict(TRACE["labelled"], device_ms=0.0))),
    ("launches_per_frame.live",
     dict(TRACE, labelled=dict(TRACE["labelled"], launches=0))),
    ("idle_share.stream", dict(TRACE, busy_s=0.0)),
    ("step_mfu.accuracy", dict(TRACE, busy_s=0.0)),
    ("graph_replay_share.stream",       # no graphed layer counted
     dict(TRACE, host=dict(TRACE["host"], counters={"frames": 100}))),
    ("rowops_host_ms.stream",
     dict(TRACE, host=dict(TRACE["host"], spans={"chunk": 1.0}))),
    ("issue_ms_p50.live", dict(TRACE, host=dict(TRACE["host"],
                                                chunk_ms=[])))])
def test_silent_where_there_is_nothing(name, trace):
    assert reader(name)(trace) is None


def test_graph_replays_without_eager_read_100():
    t = dict(TRACE, host=dict(TRACE["host"], counters={
        "fusionnet.replays": 128, "fusionnet.eager": 0,
        "fusionnet.captures": 1}))
    assert reader("graph_replay_share.stream")(t) == 100.0


def _graph_events(frames=4, kernels=12):
    """A labelled stretch of ``frames`` chunks in which each row front is
    one graph launch owning ``kernels`` kernels, and FusionNet two
    calls: the port's spans and the profiler's calls and work only."""
    ev, corr, t = [], 0, 0
    for _ in range(frames):
        ev.append(("span", "chunk", t, t + 1000, 0))
        ev.append(("span", "rowops.front", t + 10, t + 100, 0))
        corr += 1
        ev.append(("call", "cudaGraphLaunch", t + 20, t + 30, corr))
        for k in range(kernels):
            s = t + 40 + 10 * k
            ev.append(("work", f"front_kernel_{k}", s, s + 5, corr))
        ev.append(("span", "fusionnet", t + 300, t + 400, 0))
        for j in range(2):
            corr += 1
            ev.append(("call", "cudaLaunchKernel", t + 310 + j, t + 311 + j,
                       corr))
            ev.append(("work", "net", t + 500 + 100 * j, t + 550 + 100 * j,
                       corr))
        t += 1000
    return ev


def test_graph_launch_read_from_spans_alone():
    """A graph launch under ``rowops.front`` owns its kernels: the row-op
    and launch metrics read them with no call of a row function."""
    frames, kernels = 4, 12
    red = tracing.reduce_events(_graph_events(frames, kernels))
    trace = {"labelled": spans.labelled_readings(red, frames)}
    assert reader("launches_per_frame.stream")(trace) == 3.0
    assert reader("rowops_device_ms.stream")(trace) == pytest.approx(
        kernels * 5e-6)
    assert reader("fusionnet_device_ms.stream")(trace) == pytest.approx(
        2 * 50e-6)
    gaps = dict(spans.idle_gaps(red))
    assert set(gaps) <= {"rowops.front", "fusionnet", "chunk"}
    busy = frames * (kernels * 5 + 2 * 50)
    assert sum(gaps.values()) == pytest.approx((frames * 1000 - busy) * 1e-9)


def test_idle_gaps_unclaimed_outside_every_span():
    ev = [("span", "chunk", 0, 100, 0), ("span", "chunk", 200, 300, 0),
          ("call", "cudaLaunchKernel", 10, 11, 1),
          ("work", "a", 20, 50, 1),
          ("call", "cudaLaunchKernel", 210, 211, 2),
          ("work", "b", 150, 260, 2)]
    gaps = dict(spans.idle_gaps(tracing.reduce_events(ev)))
    assert gaps == pytest.approx({"chunk": 60e-9, "unclaimed": 100e-9})


def test_host_readings_of_a_tracer():
    with tracing.enabled() as tr:
        for _ in range(3):
            with tracing.chunk(2), tracing.span("rowops.front"):
                tracing.count("fusionnet.replays")
    got = spans.host_readings(tr)
    assert got["frames"] == 6 and len(got["chunk_ms"]) == 3
    assert got["counters"]["fusionnet.replays"] == 3
    assert set(got["spans"]) == {"chunk", "rowops.front"}
    assert got["spans"]["chunk"] >= got["spans"]["rowops.front"] > 0


class _Event:
    def __init__(self, start, end, on_device, name="k"):
        self._start, self._end = start, end
        self._on, self._name = on_device, name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._on
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def name(self):
        return self._name


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_busy_seconds_counts_device_overlap_once():
    events = [_Event(10, 20, True), _Event(15, 30, True),
              _Event(0, 100, False), _Event(40, 50, True)]
    assert spans.busy_seconds(_prof(events)) == pytest.approx(30e-9)


def test_device_readings_kernels_and_k1():
    events = [_Event(10, 20, True, "a"), _Event(15, 30, True,
                                                "shadow_build_kernel<f>"),
              _Event(0, 100, False, "cudaLaunchKernel"),
              _Event(40, 50, True, "a")]
    got = spans.device_readings(_prof(events), {"wall_s": 1.0, "frames": 4})
    assert got["busy_s"] == pytest.approx(30e-9)
    assert got["k1_device_s"] == pytest.approx(15e-9)
    assert got["kernels"]["a"] == pytest.approx(20e-9)
    assert (got["wall_s"], got["frames"]) == (1.0, 4)


def test_merge_intervals():
    assert spans.merge_intervals([(10, 20), (15, 30), (40, 50),
                                  (70, 80)]) == [[10, 30], [40, 50],
                                                 [70, 80]]


@pytest.mark.parametrize("name,expect", [
    ("accuracy.stream", {"setup_s", "device_ms_per_frame"}),
    ("speed.stream", {"setup_s", "device_ms_per_frame"})])
def test_end_to_end_of_a_stream_cell(name, expect):
    run = types.SimpleNamespace(cell=harness.load_cell(name))
    window = {"frames": 640, "wall_s": 32.0, "fps": 20.0, "busy_s": 8.96}
    out = harness.end_to_end(run, window, 15.0)
    assert set(out) == expect
    assert out["device_ms_per_frame"] == pytest.approx(14.0)
    assert out["setup_s"] == 15.0
