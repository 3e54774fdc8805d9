"""The traced run (``--trace 1``) at a tiny size on the CPU: K1's byte
count from the port's dirty carry, and the per-layer metrics each cell
reports."""

import time

import pytest

from gpubench import harness
from gpubench.tests.tiny import tiny_cell

CELLS = ["accuracy.stream", "speed.stream", "accuracy.live"]


def test_k1_bytes_read_the_masks_k1_was_given(monkeypatch):
    """The count from ``RowStream.dirty`` equals the count taken from each
    ``build_shadow_dirty`` call's own mask over the same frames."""
    from segfusion_tpu_torch.ops import rowvol
    cell = tiny_cell("speed.stream")
    cell.config["assumed"].update(volume_shape=[44, 44, 44],
                                  volume_origin=[-1.76] * 3)
    run = harness.build(cell, 2 ** 31 + 77, "cpu")
    harness.warm_up(run)
    harness.run_window(run, 0.0, 1)        # a carry from a frame before
    seen = []
    orig = rowvol.build_shadow_dirty

    def witness(geo, prev, dirty, layout):
        seen.append(dirty.clone())
        return orig(geo, prev, dirty, layout)
    monkeypatch.setattr(rowvol, "build_shadow_dirty", witness)
    start, carry = len(run.order), run.stream.dirty.clone()
    window = harness.run_window(run, 0.0, 3)
    per_call = len(seen)
    assert per_call == window["frames"] == 12
    got = harness.k1_bytes(run, start, window["frames"], carry)
    again, seen = seen[per_call:], seen[:per_call]
    # handed in again, each block after the first is given its mask anew
    assert len(again) == per_call
    assert carry.equal(seen[0]) and not again[0].equal(seen[0])
    for a, b in zip(seen[1:], again[1:]):
        assert a.equal(b)
    lay = run.layout
    size = lay.geo_rows * 128 * run.pipe.geo_dtype.itemsize \
        + lay.shadow_rows * 128 * 4
    want = sum(float(d[:-1].float().mean()) * size for d in seen)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < per_call * size
    assert run.order[start:] == run.order[start:start + 12] * 2


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_its_metrics(name):
    """Every per-layer metric of the cell that a CPU run can read (not
    those from the device's trace), and a correct result."""
    cell = tiny_cell(name)
    res = harness.execute(cell, 2 ** 31 + 4243, 1.0, True, "cpu",
                          time.perf_counter(), log=lambda *a, **k: None)
    listed = {m["name"] for m in cell.metrics("per_layer")}
    host = {m["name"] for m in cell.metrics("per_layer")
            if m["source"] != "device_trace"}
    assert set(res["metrics"]) == host and host < listed
    graphs = res["metrics"].pop("graph_replay_share.stream", 0.0)
    assert graphs == 0.0        # no CUDA graph off the card: every call eager
    assert all(v > 0 for v in res["metrics"].values()), res["metrics"]
    correct, checks = harness.judge(res["numbers"], cell.limits)
    assert correct, checks
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
