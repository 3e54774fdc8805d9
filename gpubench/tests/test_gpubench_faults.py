"""``correct`` comes out false when the timed path is broken underneath:
the harness's run at a tiny size on the CPU (the look for a card
skipped), with each fault a stream cell can have planted in the port's
call. A cell on one card has no exchange between chips to leave out."""

import time

import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import tiny_cell

CELLS = ["accuracy.stream", "speed.stream", "accuracy.live"]


def _run(name):
    cell = tiny_cell(name)
    res = harness.execute(cell, 2 ** 31 + 4242, 1.0, False, "cpu",
                          time.perf_counter(), log=lambda *a, **k: None)
    return harness.judge(res["numbers"], cell.limits)


def _unchanged(monkeypatch, Pipeline):
    def stalled(self, layout, stream, frames):
        time.sleep(0.05)        # a step's time, so the window stays short
        return stream
    monkeypatch.setattr(Pipeline, "fuse_sequence_rows", stalled)


def _half_left_out(monkeypatch, Pipeline):
    orig = Pipeline.fuse_sequence_rows
    seen = [0]

    def half(self, layout, stream, frames):
        T = frames["depth"].shape[0]
        keep = [i for i in range(T) if (seen[0] + i) % 2 == 0]
        seen[0] += T
        if not keep:
            time.sleep(0.05)
            return stream
        idx = torch.tensor(keep)
        return orig(self, layout, stream,
                    {k: v[idx] for k, v in frames.items()})
    monkeypatch.setattr(Pipeline, "fuse_sequence_rows", half)


def _estimate_altered(monkeypatch, Pipeline):
    orig = Pipeline._network_estimate
    monkeypatch.setattr(Pipeline, "_network_estimate",
                        lambda self, *a, **k: -orig(self, *a, **k))


def _labels_altered(monkeypatch, Pipeline):
    orig = Pipeline._predict_semantics_batched

    def shifted(self, images, depths):
        ids, scores = orig(self, images, depths)
        return (ids + 1) % self.n_classes, scores
    monkeypatch.setattr(Pipeline, "_predict_semantics_batched", shifted)


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half_left_out,
          "estimate_altered": _estimate_altered,
          "labels_altered": _labels_altered}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    correct, checks = _run(name)
    assert correct, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    if fault == "labels_altered" and name.startswith("speed"):
        pytest.skip("replica_speed labels nothing")
    from segfusion_tpu_torch.core.pipeline import Pipeline
    FAULTS[fault](monkeypatch, Pipeline)
    correct, checks = _run(name)
    assert not correct, checks
