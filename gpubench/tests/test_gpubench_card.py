"""On the card: a CUDA graph replayed under a port span gives its kernels to
that span, and short runs of each cell through ``gpubench/run.py``:
``correct`` has to come out true, and a traced run reports every
per-layer metric the cell lists."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["accuracy.stream", "speed.stream", "accuracy.live"]


def _run(name, trace):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    return line


@pytest.mark.gpubench_card
@pytest.mark.parametrize("name", ["accuracy.stream", "speed.stream"])
def test_cell_on_the_card(card, name):
    _run(name, 0)


@pytest.mark.gpubench_card
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_reports_every_metric(card, name):
    from gpubench import harness
    listed = {m["name"] for m in harness.load_cell(name).metrics(
        "per_layer")}
    line = _run(name, 1)
    assert set(line["metrics"]) == listed
    assert all(m["value"] > 0 for m in line["metrics"].values()), line
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]


@pytest.mark.gpubench_card
def test_graph_kernels_go_to_the_span_that_replayed_it(card):
    from segfusion_tpu_torch.utils import tracing
    from gpubench import spans
    x = torch.randn(1 << 16, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):           # the first calls, uncaptured
        y = (x * 2.0).sin_().add_(1.0)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = (x * 2.0).sin_().add_(1.0)
    torch.cuda.synchronize(card)
    replays = 5

    def stretch():
        for _ in range(replays):
            with tracing.chunk(1), tracing.span("rowops.front"):
                graph.replay()
            with tracing.chunk(1), tracing.span("fusionnet"):
                y.mul_(0.5)
        torch.cuda.synchronize(card)

    with tracing.enabled(labels=True):
        prof, _ = spans.profile(stretch, card, host=True)
    red = tracing.reduce_profile(prof)
    front = red["spans"]["rowops.front"]
    assert front["launches"] == replays             # a graph launch once
    assert sum(front["kernels"].values()) == pytest.approx(
        front["device_ms"])
    assert len(front["kernels"]) >= 2 and front["device_ms"] > 0
    assert red["spans"]["fusionnet"]["launches"] == replays
    assert red["unclaimed"]["device_ms"] == 0
    lab = spans.labelled_readings(red, 2 * replays)
    assert lab["spans_device_ms"]["rowops.front"] == front["device_ms"]
