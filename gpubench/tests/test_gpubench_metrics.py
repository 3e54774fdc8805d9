"""The per-layer readers and the trace arithmetic on hand-built traces."""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from gpubench import harness, spans

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRACE = {"wall_s": 2.0, "busy_s": 1.5, "frames": 64,
         "flops_per_frame": 1e11,
         "spans_ms": {"fusionnet": 300.0, "adapnet": 200.0,
                      "rowops": 50.0},
         "frames_spanned": 100,
         "window_fps": 21.5,
         "k1": {"device_s": 0.01, "bytes": 0.5 * 3.35e10},
         "service_ms": [30.0, 10.0, 20.0]}


@pytest.mark.parametrize("name,value", [
    ("idle_share.stream", 25.0),
    ("step_mfu.stream", 100 * 1e11 * 64 / 2.0 / 989e12),
    ("fusionnet_ms.stream", 3.0),
    ("rowops_ms.stream", 0.5),
    ("k1_roofline.stream", 50.0),
    ("fuse_fps.accuracy", 21.5),
    ("idle_share.accuracy", 25.0),
    ("step_mfu.accuracy", 100 * 1e11 * 64 / 2.0 / 989e12),
    ("fusionnet_ms.accuracy", 3.0),
    ("adapnet_ms.accuracy", 2.0),
    ("rowops_ms.accuracy", 0.5),
    ("k1_roofline.accuracy", 50.0),
    ("service_ms_p50.live", 20.0)])
def test_reader(name, value):
    assert reader(name)(TRACE) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", [p.stem for p in METRICS.glob("*.py")
                                  if not p.stem.startswith("_")])
def test_nothing_to_read(name):
    assert reader(name)({}) is None


def test_no_adapnet_in_a_depth_cell():
    t = dict(TRACE, spans_ms={"fusionnet": 1.0})
    assert reader("adapnet_ms.accuracy")(t) is None


class _Event:
    def __init__(self, start, end, on_device):
        self._start, self._end = start, end
        self._on = on_device

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._on
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def test_busy_seconds_counts_device_overlap_once():
    events = [_Event(10, 20, True), _Event(15, 30, True),
              _Event(0, 100, False), _Event(40, 50, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    assert spans.busy_seconds(prof) == pytest.approx(30e-9)


@pytest.mark.parametrize("name,expect", [
    ("accuracy.stream", {"setup_s", "device_ms_per_frame"}),
    ("speed.stream", {"setup_s", "fuse_fps"})])
def test_end_to_end_of_a_stream_cell(name, expect):
    run = types.SimpleNamespace(cell=harness.load_cell(name))
    window = {"frames": 640, "wall_s": 32.0, "fps": 20.0, "busy_s": 8.96}
    out = harness.end_to_end(run, window, 15.0)
    assert set(out) == expect
    if "device_ms_per_frame" in out:
        assert out["device_ms_per_frame"] == pytest.approx(14.0)
    if "fuse_fps" in out:
        assert out["fuse_fps"] == 20.0


def test_busy_union_and_gaps():
    busy = spans.merge_intervals([(10, 20), (15, 30), (40, 50), (70, 80)])
    assert busy == [[10, 30], [40, 50], [70, 80]]
    labels = [("fusionnet", 35, 45), ("rowops", 60, 75),
              ("k1", 69, 71)]
    gaps = spans.gaps_by_layer(busy, labels, 0, 100)
    assert gaps["host between layers"] == pytest.approx((10 + 20) * 1e-6)
    assert gaps["fusionnet"] == pytest.approx(10e-6)
    assert gaps["k1"] == pytest.approx(20e-6)
