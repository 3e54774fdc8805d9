"""The port's tracing utilities (``segfusion_tpu_torch/utils/tracing.py``):
the tracer's spans and counters inside ``Pipeline`` and the folded
executor (off unless enabled; nested, numbered by chunk; no change to
what the pipeline computes), the reduction of a profiler's trace to the
spans, ``trace``'s files, and ``nan_guard`` beside the JAX package's
(tests/test_tracing.py; checked per operation, as
``checkify.float_checks``)."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.utils.tracing import nan_guard as j_nan_guard
from segfusion_tpu_torch.config import Config, _DEFAULTS, _merge_defaults
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.data.synthetic import Synthetic
from segfusion_tpu_torch.utils import tracing
from segfusion_tpu_torch.utils.tracing import nan_guard, trace
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

N_CLASSES = 8


def _config(strategy="gt", **settings):
    cfg = _merge_defaults(Config({}), _DEFAULTS)
    cfg.DATA.update(resx=16, resy=16, input="tof_depth", init_value=0.24,
                    semantics="class8", semantic_strategy=strategy,
                    semantic_grid=False, n_frames=6, voxel_resolution=0.1,
                    noise_sigma=0.004, n_classes=N_CLASSES, n_scenes=1)
    cfg.FUSION_MODEL.update(n_points=5, n_tail_points=4, growth_factor=2,
                            use_semantics=True, dropout=0.0,
                            compute_dtype="bfloat16")
    cfg.SEMANTIC_2D_MODEL.n_classes = N_CLASSES
    cfg.SETTINGS.update(settings)
    return cfg


class _Segmenter:
    """Logits drawn from the frames' count, in place of AdapNet++."""

    def apply_fn_batched(self, images, depths):
        g = torch.Generator().manual_seed(images.shape[0])
        return torch.randn(images.shape[:3] + (N_CLASSES,), generator=g)


def _batch(item):
    return {k: (np.asarray(v)[None] if isinstance(v, np.ndarray) else v)
            for k, v in item.items()} | {"frame_id": [item["frame_id"]]}


@pytest.fixture(scope="module")
def scene():
    cfg = _config()
    data = Synthetic(cfg.DATA, device="cpu")
    s = data.scenes[0]
    pipe = Pipeline(cfg, device="cpu")
    frames = pipe._stack_host_frames([
        pipe._frame_from_batch(_batch(data[i]), cfg.DATA.input)
        for i in range(6)])
    return data, s, frames


def _stream(cfg, scene, chunks=((0, 3), (3, 6)), segmenter=None):
    """A fresh pipeline's row stream over ``chunks`` of the scene's
    frames; returns the final stream."""
    data, s, frames = scene
    pipe = Pipeline(cfg, device="cpu", segmenter=segmenter)
    db = Database(data, cfg.DATA, device="cpu")
    layout, rv = pipe._rows_from_volume(db.volumes[s])
    stream = pipe._new_stream(layout, rv)
    for a, b in chunks:
        stream = pipe.fuse_sequence_rows(
            layout, stream, {k: v[a:b] for k, v in frames.items()})
    return stream


def _train(cfg, scene):
    """A fresh training pipeline's ``train_sequence_rows`` chunk over the
    scene's six frames (a reset at the fourth): loss, state, gradients."""
    data, s, frames = scene
    pipe = Pipeline(cfg, device="cpu", train=True)
    db = Database(data, cfg.DATA, device="cpu")
    layout, rv = pipe._rows_from_volume(db.volumes[s])
    gt_shadow = pipe._gt_shadow(layout, db.scenes_gt[s])
    resets = torch.tensor([False, False, False, True, False, False])
    loss, stream = pipe.train_sequence_rows(
        layout, pipe._new_stream(layout, rv), gt_shadow, frames, resets)
    grads = [p.grad.clone() for p in pipe.fusion_net.parameters()]
    return loss, stream, grads


def _state(stream):
    return [stream.rv.geo, stream.rv.key, stream.shadow, stream.dirty]


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_records_nothing_and_never_labels(scene, monkeypatch):
    """Off: a stream runs with ``record_function`` refused, no tracer is
    set, and a span, chunk or block is the one shared no-op that calls no
    builtin (no clock, no torch function); ``enabled()`` without labels
    records spans and still never labels."""
    _no_record_function(monkeypatch)
    _stream(_config(), scene)
    assert tracing._TRACER is None
    assert tracing.span("a") is tracing.chunk(3, 2) is tracing.block()

    builtin_calls = []

    def watch(frame, event, arg):
        if event == "c_call" and frame.f_code.co_filename == tracing.__file__:
            builtin_calls.append(arg)
    sys.setprofile(watch)
    try:
        with tracing.span("a"):
            with tracing.chunk(3, 2):
                with tracing.block():
                    pass
    finally:
        sys.setprofile(None)
    assert builtin_calls == []

    with tracing.enabled() as tr:
        _stream(_config(), scene, chunks=((0, 2),))
    assert tr.counters["chunks"] == 1 and len(tr.spans) > 10
    assert tracing._TRACER is None


# the span each span may open inside
PARENTS = {"chunk": {None}, "adapnet": {"chunk"}, "block": {"chunk"},
           "rowops.front": {"block"}, "k1": {"block"},
           "rowops.dirty": {"block"}, "rowops.extract": {"block"},
           "fusionnet": {"block"}, "rowops.updates": {"block"},
           "rowops.scatter": {"block"}, "fusionnet.fold": {"fusionnet"},
           "fusionnet.head": {"fusionnet"}, "fusionnet.vortex": {"fusionnet"},
           "fusionnet.pred": {"fusionnet"},
           "fusionnet.taps": {"fusionnet.head", "fusionnet.vortex"}}


def test_spans_nest_and_carry_their_chunk(scene):
    """Two chunks of a predicted-label stream: every span opens inside
    the span it belongs in, within its parent's interval, and carries the
    number of the chunk it is in."""
    with tracing.enabled(labels=True) as tr:
        _stream(_config("predict"), scene, segmenter=_Segmenter())
    spans = tr.spans
    assert set(PARENTS) == {s["name"] for s in spans}
    assert tr.counters == {"frames": 6, "blocks": 6, "chunks": 2,
                           "fusionnet.eager": 6}
    for s in spans:
        parent = spans[s["parent"]] if s["parent"] >= 0 else None
        assert (parent and parent["name"]) in PARENTS[s["name"]], s
        root = s
        while root["parent"] >= 0:
            root = spans[root["parent"]]
        assert root["name"] == "chunk" and s["chunk"] == root["chunk"]
        if parent:
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    roots = [s for s in spans if s["name"] == "chunk"]
    assert [r["chunk"] for r in roots] == [0, 1]
    assert [r["attrs"] for r in roots] == [{"T": 3, "frame_block": 1}] * 2
    summary = tr.summary()
    assert summary["block"]["count"] == 6
    assert summary["adapnet"]["count"] == 2
    assert 0.0 <= summary["chunk"]["self_ms"] <= summary["chunk"]["host_ms"]


def test_frames_count_the_real_frames_of_a_padded_chunk(scene):
    """frame_block 2 over 3 frames pads one all-masked frame: 3 frames,
    2 blocks, 1 chunk; a span after the chunk belongs to none."""
    with tracing.enabled() as tr:
        _stream(_config(frame_block=2), scene, chunks=((0, 3),))
        with tracing.span("after"):
            pass
    assert tr.counters == {"frames": 3, "blocks": 2, "chunks": 1,
                           "fusionnet.eager": 2}
    assert tr.spans[-1] == dict(tr.spans[-1], name="after", parent=-1,
                                chunk=None)
    (root,) = [s for s in tr.spans if s["name"] == "chunk"]
    assert root["attrs"] == {"T": 3, "frame_block": 2}
    assert len(tr.durations_ms("block")) == 2


@pytest.mark.parametrize("labels", [False, True])
def test_tracing_leaves_the_state_bit_identical(scene, labels):
    """The dirty carry over two chunks with gt labels, and a training
    chunk (loss, state, gradients): the same bits with the tracer off and
    on."""
    cfg = _config()
    off = _state(_stream(cfg, scene))
    loss_off, train_off, grads_off = _train(cfg, scene)
    with tracing.enabled(labels=labels) as tr:
        on = _state(_stream(cfg, scene))
        loss_on, train_on, grads_on = _train(cfg, scene)
    assert tr.counters == {"frames": 12, "blocks": 6, "chunks": 3,
                           "fusionnet.eager": 6}
    names = {s["name"] for s in tr.spans}
    assert {"train.frame", "train.loss", "train.backward",
            "rowops.integrate"} <= names
    for a, b in zip(off + _state(train_off) + grads_off + [loss_off],
                    on + _state(train_on) + grads_on + [loss_on]):
        assert torch.equal(a, b)


def _events():
    """chunk [0, 1000] > block [10, 900] > fusionnet [100, 500] >
    fusionnet.taps [200, 300]: launches in each, a graph launch (one
    call, two kernels), a call with no work, a call outside every span,
    and a kernel whose call is not in the trace."""
    return [
        ("span", "chunk", 0, 1000, 0), ("span", "block", 10, 900, 0),
        ("span", "fusionnet", 100, 500, 0),
        ("span", "fusionnet.taps", 200, 300, 0),
        ("call", "cudaLaunchKernel", 50, 55, 1),
        ("work", "k_block", 60, 80, 1),
        ("call", "cudaLaunchKernel", 150, 155, 2),
        ("work", "k_net", 160, 200, 2),
        ("call", "cudaLaunchKernel", 210, 215, 3),
        ("work", "k_add", 350, 400, 3),
        ("call", "cudaGraphLaunch", 250, 260, 4),
        ("work", "k_add", 400, 420, 4), ("work", "k_mm", 430, 440, 4),
        ("call", "cudaStreamSynchronize", 600, 610, 6),
        ("call", "cudaLaunchKernel", 1200, 1205, 5),
        ("work", "k_late", 1210, 1220, 5),
        ("work", "k_orphan", 950, 960, 7)]


def test_reduce_events_by_span():
    red = tracing.reduce_events(_events())
    sp, un = red["spans"], red["unclaimed"]
    ns = 1e-6      # one nanosecond in ms
    assert {k: v["launches"] for k, v in sp.items()} == {
        "chunk": 0, "block": 1, "fusionnet": 1, "fusionnet.taps": 2}
    assert {k: v["launches_total"] for k, v in sp.items()} == {
        "chunk": 4, "block": 4, "fusionnet": 3, "fusionnet.taps": 2}
    assert red["launches"] == 5 and un["launches"] == 1
    assert sp["block"]["device_ms"] == pytest.approx(20 * ns)
    assert sp["fusionnet"]["device_ms"] == pytest.approx(40 * ns)
    assert sp["fusionnet.taps"]["device_ms"] == pytest.approx(80 * ns)
    assert sp["fusionnet"]["device_ms_total"] == pytest.approx(120 * ns)
    assert sp["chunk"]["device_ms_total"] == pytest.approx(140 * ns)
    assert sp["fusionnet.taps"]["kernels"] == pytest.approx(
        {"k_add": 70 * ns, "k_mm": 10 * ns})
    assert un["device_ms"] == pytest.approx(20 * ns)
    assert un["kernels"] == pytest.approx({"k_late": 10 * ns,
                                           "k_orphan": 10 * ns})
    assert red["device_ms"] == pytest.approx(160 * ns)
    # idle, put down where the device woke: block at 60; fusionnet at
    # 160, 350 (taps had closed) and 430; chunk at 950 and the window's end
    assert {k: v["idle_s"] for k, v in sp.items()} == pytest.approx({
        "chunk": 550e-9, "block": 60e-9, "fusionnet": 240e-9,
        "fusionnet.taps": 0.0})
    assert un["idle_s"] == 0.0
    assert {k: v["count"] for k, v in sp.items()} == {
        "chunk": 1, "block": 1, "fusionnet": 1, "fusionnet.taps": 1}


def test_reduce_events_without_spans_claims_nothing():
    red = tracing.reduce_events([e for e in _events() if e[0] != "span"])
    assert red["spans"] == {}
    assert red["unclaimed"]["launches"] == 5
    assert red["unclaimed"]["device_ms"] == pytest.approx(160e-6)


@pytest.mark.parametrize("name,fn,jfn,ok,bad", [
    ("log", torch.log, jnp.log, [1.0, 2.0], [-1.0]),
    ("sqrt", torch.sqrt, jnp.sqrt, [4.0], [-4.0]),
])
def test_nan_guard_trips_like_checkify(name, fn, jfn, ok, bad):
    """Both packages' guards pass finite results through and raise on a
    NaN made from finite inputs."""
    guarded = nan_guard(fn)
    jguarded = j_nan_guard(jax.jit(jfn))
    out = guarded(torch.tensor(ok))
    assert torch.equal(out, fn(torch.tensor(ok)))
    jguarded(jnp.asarray(ok))
    with pytest.raises(FloatingPointError, match="non-finite"):
        guarded(torch.tensor(bad))
    with pytest.raises(Exception):
        jguarded(jnp.asarray(bad))


def test_nan_guard_checks_intermediates():
    """A NaN that a later op hides (``nan_to_num``) still trips: every
    operation is checked, not only the outputs; an infinity too. Inputs
    that are already non-finite do not trip the op that reads them."""
    def hidden(x):
        return torch.nan_to_num(torch.log(x))

    assert torch.isfinite(hidden(torch.tensor([-1.0]))).all()
    with pytest.raises(FloatingPointError):
        nan_guard(hidden)(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError):
        nan_guard(lambda x: 1.0 / x)(torch.tensor([0.0]))
    passed = nan_guard(lambda x: x * 2)(torch.tensor([float("inf")]))
    assert torch.isinf(passed).all()


def test_nan_guard_disabled_passthrough():
    f = lambda x: x * 2  # noqa: E731
    assert nan_guard(f, enabled=False) is f


def test_trace_writes_and_is_a_no_op_when_falsy(tmp_path):
    for off in (None, ""):
        with trace(off) as prof:
            torch.ones(4).sum()
        assert prof is None
    with trace(str(tmp_path / "tr")):
        torch.ones(8).cumsum(0)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "")
               for e in data["traceEvents"])


def test_trace_writes_the_spans_of_a_stream(tmp_path, scene):
    """``trace`` around two chunks: ``spans.json`` holds the spans, the
    counters, their host totals and the profiler trace reduced to them
    (each span's range found in the trace; no card here, so no launch);
    tracing is off again after the block."""
    with trace(str(tmp_path / "tr")):
        _stream(_config(), scene)
    assert tracing._TRACER is None
    data = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert data["counters"] == {"frames": 6, "blocks": 6, "chunks": 2,
                                "fusionnet.eager": 6}
    assert len(data["spans"]) == sum(s["count"]
                                     for s in data["summary"].values())
    red = data["reduction"]["spans"]
    assert {k: v["count"] for k, v in red.items()} == {
        k: v["count"] for k, v in data["summary"].items()}
    assert data["reduction"]["launches"] == 0
    trace_json = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "sf:chunk" for e in trace_json["traceEvents"])
