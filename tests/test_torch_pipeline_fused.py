"""The port's Pipeline on the folded executor (``SETTINGS.fused_net``) and
the matmul-form training forward (``fused_net_train``): a small stream
against the JAX Pipeline with the same settings, every inference and
training path routed through ``Pipeline._network_estimate``, one training
chunk per path, and the fold following the parameters as they change in
place.

The streams are the JAX Synthetic frames of ``tests/test_torch_train_pipeline``
(44x48x44 volume, 32x32 frames, v3 gf 2 with the semantic input, gt
labels, dropout 0), f32 nets with the settings forced on, so both
packages run their executors in float32 where they agree to rounding.
"""

import copy

import numpy as np
import pytest
import torch

from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.models import fusionnet_fast as ff
from segfusion_tpu_torch.models.fusionnet import FusionNetV3
from segfusion_tpu_torch.parallel.mesh import scene_mesh
from segfusion_tpu_torch.parallel.scene_parallel import stack_volumes
from segfusion_tpu_torch.parallel.spatial import SpatialShardedFusion
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_train_pipeline import (RESETS, _batch,  # noqa: F401
                                             _max_err, _reference_f64,
                                             _run_jax, _run_port, setup)

N_FRAMES = 4


def _configure(cfg, **settings):
    cfg = copy.deepcopy(cfg)
    cfg.SETTINGS.update(settings)
    return cfg


def _port(cfg, params, stats, jdata, train=False):
    pcfg = Config(copy.deepcopy(cfg))
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(
        params, stats, pcfg.FUSION_MODEL), device="cpu", train=train)
    return pipe, Database(jdata, pcfg.DATA, device="cpu")


@pytest.fixture
def no_eager_forward(monkeypatch):
    """FusionNetV3's eager forward raises: a path that still calls it
    fails."""
    def refuse(self, data):
        raise AssertionError("the eager FusionNet forward ran")
    monkeypatch.setattr(FusionNetV3, "forward", refuse)


@pytest.mark.parametrize("integration", ["rows", "scalar"])
def test_fused_stream_matches_jax(setup, integration, no_eager_forward):
    """Four frames through ``fuse_many`` (the row path's chunked stream)
    or per-frame ``fuse`` (the flat path) with ``fused_net: on`` in both
    packages: num within 5e-4 (tests/test_fastnet.py's fused-against-Flax
    bound; measured 1.8e-5), keys exact; the weights, which the net does
    not touch, within tests/test_torch_per_frame.py's atol 1e-4 + rtol
    1e-4 (the two scatter-adds sum in their own orders: 9.5e-6 with the
    executor on or off, where tests/test_fastnet.py holds JAX to JAX at
    1e-6)."""
    cfg, jdata, _, params, stats, _ = setup
    cfg = _configure(cfg, fused_net="on", integration=integration)
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    pipe, db = _port(cfg, params, stats, jdata)
    assert pipe.fused_net and jpipe.fused_net
    batches = [_batch(jdata[i]) for i in range(N_FRAMES)]
    if integration == "rows":
        jpipe.fuse_many(batches, jdb, params, stats, chunk=N_FRAMES)
        pipe.fuse_many(batches, db, chunk=N_FRAMES)
    else:
        for b in batches:
            jpipe.fuse(b, jdb, params, stats)
            pipe.fuse(b, db)
    s = jdata.scenes[0]
    jv, v = jdb.volumes[s], db.volumes[s]
    jw = np.asarray(jv.weights)
    assert (jw > 0.05).sum() > 1000
    np.testing.assert_allclose(v.weights.numpy(), jw, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(v.num.numpy(), np.asarray(jv.num), atol=5e-4)
    np.testing.assert_array_equal(v.semkey.numpy(), np.asarray(jv.semkey))


def test_every_path_runs_the_executor(setup, no_eager_forward):
    """With a bf16 v3 config (``fused_net`` and ``fused_net_train`` on by
    default) no path calls the eager module: the block stream, the
    per-frame step on the row and flat paths, the scene-folded step, the
    spatial runner, training by rows and flat, ``fuse_training``."""
    cfg, jdata, _, params, stats, frames = setup
    cfg = _configure(cfg)
    cfg.FUSION_MODEL.compute_dtype = "bfloat16"
    tframes = {k: torch.as_tensor(v[:2]) for k, v in frames.items()}
    resets = torch.zeros(2, dtype=torch.bool)
    s = jdata.scenes[0]
    for integration in ("rows", "scalar"):
        icfg = _configure(cfg, integration=integration)
        pipe, db = _port(icfg, params, stats, jdata)
        assert pipe.fused_net and pipe.fused_net_train
        pipe.fuse(_batch(jdata[0]), db)
        pipe.fuse_sequence(db.volumes[s], tframes)
        stacked = stack_volumes([db.volumes[s], copy.deepcopy(
            db.volumes[s])])
        pipe.fuse_sequence_scenes(stacked, {k: x[None].expand(
            (2,) + x.shape) for k, x in tframes.items()})
        runner = SpatialShardedFusion(pipe, scene_mesh("x", ["cpu"] * 4))
        runner.fuse_sequence(runner.shard(db.volumes[s]), {
            k: x.numpy() for k, x in tframes.items()})

        tpipe, tdb = _port(icfg, params, stats, jdata, train=True)
        loss, _ = tpipe.train_sequence(tdb.volumes[s], tdb.scenes_gt[s],
                                       tframes, resets)
        assert torch.isfinite(loss)
        assert torch.isfinite(tpipe.fuse_training(_batch(jdata[1]), tdb))


@pytest.mark.parametrize("integration", ["rows", "scalar"])
def test_train_chunk_per_path(setup, integration):
    """Four training frames (a reset before the third) with
    ``fused_net_train: on``: the matmul form against the eager train-mode
    module on the same path (loss within rtol 1e-5, gradients within
    5e-3, the weights within 1e-4); on the row path also against the JAX
    package's ``train_sequence_rows`` on its executor (the loss within
    1e-3, the gradients no farther from JAX's than JAX's are from the
    float64 reference plus 5e-3, as tests/test_torch_train_pipeline.py
    holds the eager module)."""
    cfg, jdata, jpipe, params, stats, frames = setup
    tframes = {k: torch.as_tensor(v) for k, v in frames.items()}
    s = jdata.scenes[0]
    runs = {}
    for fused in ("on", "off"):
        fcfg = _configure(cfg, fused_net_train=fused, integration=integration)
        pipe, db = _port(fcfg, params, stats, jdata, train=True)
        assert pipe.fused_net_train == (fused == "on")
        loss, out = pipe.train_sequence(db.volumes[s], db.scenes_gt[s],
                                        tframes, torch.as_tensor(RESETS))
        net = pipe.fusion_net
        runs[fused] = (float(loss), {n: p.grad.clone() for n, p in
                                     net.named_parameters()},
                       out.weights.clone())
    (l_on, g_on, w_on), (l_off, g_off, w_off) = runs["on"], runs["off"]
    assert l_on == pytest.approx(l_off, rel=1e-5)
    assert max(float((g_on[n] - g_off[n]).abs().max()) for n in g_on) <= 5e-3
    torch.testing.assert_close(w_on, w_off, rtol=0, atol=1e-4)
    if integration != "rows":
        return
    fcfg = _configure(cfg, fused_net_train="on")
    jpipe = JPipeline(fcfg)
    assert jpipe.fused_net_train
    jl, jg, _, _ = _run_jax(fcfg, jdata, jpipe, params, stats, frames)
    loss, grads, _, _, inputs, _ = _run_port(fcfg, params, stats, frames,
                                             dirty=True)
    _, ref_grads, _, _ = _reference_f64(JPipeline(cfg), params, stats,
                                        inputs)
    assert abs(loss - jl) <= 1e-3
    assert _max_err(grads, ref_grads) <= 5e-3
    assert _max_err(grads, jg) <= _max_err(jg, ref_grads) + 5e-3


def test_fold_follows_parameter_updates(setup):
    """Infer, take an optimizer step, infer again: the second estimate is
    a fresh fold's of the updated net, not the stale one's; the same
    after a train-mode BatchNorm update and after ``load_state_dict``."""
    cfg, jdata, _, params, stats, frames = setup
    cfg = _configure(cfg, fused_net="on")
    pipe, _ = _port(cfg, params, stats, jdata, train=True)
    net = pipe.fusion_net
    rng = np.random.RandomState(0)
    inputs = {"tsdf_values": rng.randn(1, 32, 32, 5) * 0.05,
              "tsdf_weights": rng.uniform(0, 3, (1, 32, 32, 5)),
              "tsdf_frame": rng.uniform(0.5, 3, (1, 32, 32, 1)),
              "semantic_frame": rng.uniform(0, 1, (1, 32, 32, 1))}
    inputs = {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in inputs.items()}

    def fresh():
        with torch.no_grad():
            return ff.FastV3(copy.deepcopy(net).eval(),
                             dtype=torch.float32)(inputs)[..., :5]

    def estimate():
        with torch.no_grad():
            return pipe._network_estimate(inputs)

    before = estimate()
    assert torch.equal(before, fresh())
    assert pipe.prepare_params() is pipe.prepare_params()  # cached

    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    pipe._network_estimate(inputs, train=True).square().mean().backward()
    opt.step()
    after_step = estimate()
    assert not torch.equal(after_step, before)
    assert torch.equal(after_step, fresh())

    with torch.no_grad():       # BatchNorm statistics moved in train mode
        pipe._network_estimate(inputs, train=True)
    after_bn = estimate()
    assert not torch.equal(after_bn, after_step)
    assert torch.equal(after_bn, fresh())

    net.load_state_dict(fusionnet_from_flax(
        params, stats, pipe.config.FUSION_MODEL).state_dict())
    assert torch.equal(estimate(), before)
