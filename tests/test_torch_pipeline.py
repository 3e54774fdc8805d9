"""Port parity for the slice as a whole: ``Pipeline.fuse_sequence_rows``
(AdapNet++ stage-2 pre-pass + FusionNet v3 + slot-row state) and
``fuse_many`` over the Database/Synthetic dataset, JAX package vs
``segfusion_tpu_torch`` with carried weights, on the CPU at a small size.

The JAX pipeline runs with f32 nets (so it takes the Flax forward, not the
folded executor) and its XLA row ops. Both sides get the same numpy
frames. Tolerances are stated per test: the nets sum in another order, so
the per-frame estimates differ at ~1e-6 and the volumes drift apart within
the bounds below; bf16 geo state adds RTNE accumulation-order noise
(tests/test_geo_bf16.py bounds).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.config import Config as JConfig, _DEFAULTS, _merge_defaults
from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.core.volume import init_scene_volume as j_init_volume
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.models.adapnet import AdapNet
from segfusion_tpu.models.adapnet import SegmenterAdapter as JSeg
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import init_scene_volume
from segfusion_tpu_torch.data.synthetic import Synthetic, SyntheticScene
from segfusion_tpu_torch.models.adapnet import SegmenterAdapter
from segfusion_tpu_torch.ops.raycast import render_depth
from segfusion_tpu_torch.utils.convert import (adapnet_from_flax,
                                               fusionnet_from_flax)
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

H = W = 32
VSHAPE = (64, 64, 64)
ORIGIN = np.array([-2.24, -2.24, -2.24], np.float32)
RES = 4.48 / 64


def _config(frame_block, sem_every, geo_dtype):
    """The headline configuration (bench.py build_config/_headline_setup)
    cut to size: FusionNet v3 gf 2, AdapNet++ stage 2, f32 nets."""
    cfg = _merge_defaults(JConfig({}), _DEFAULTS)
    cfg.DATA.resx, cfg.DATA.resy = W, H
    cfg.DATA.init_value = 0.1
    cfg.DATA.semantics = "class30"
    cfg.DATA.semantic_strategy = "predict"
    cfg.FUSION_MODEL.update(name="v3", n_points=9, n_tail_points=7,
                            growth_factor=2, use_semantics=True,
                            compute_dtype="float32")
    cfg.SEMANTIC_2D_MODEL.update(n_classes=30, stage=2)
    cfg.SETTINGS.update(frame_block=frame_block,
                        sem_integrate_every=sem_every, geo_dtype=geo_dtype,
                        rows_impl="xla")
    return cfg


def _frames(n_frames):
    """Depth trajectory rendered once (numpy), identical for both."""
    scene = SyntheticScene(seed=0, half=2.2)
    coarse, _ = scene.grid(0.08, 10.0, pad=2)
    f = 0.5 * W
    intr = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    poses = scene.camera_poses(n_frames)
    depth = render_depth(torch.as_tensor(coarse.volume),
                         torch.as_tensor(poses), torch.as_tensor(intr),
                         torch.as_tensor(coarse.origin), coarse.resolution,
                         H, W, near=0.05, far=9.0, n_steps=96).numpy()
    gray = np.clip(1.0 - depth / 9.0, 0, 1) * 255.0
    return {"depth": depth, "depth_input": depth,
            "image": np.repeat(gray[..., None], 3, axis=-1),
            "extrinsics": poses,
            "intrinsics": np.broadcast_to(intr, (n_frames, 3, 3)).copy(),
            "mask": depth > 0}


def _run_jax(cfg, frames, fparams, sparams, adapnet):
    pipe = JPipeline(cfg, segmenter=JSeg(adapnet))
    vol = j_init_volume(VSHAPE, ORIGIN, RES, 0.1)
    layout, rv = pipe._rows_from_volume(vol)
    stream = pipe.fuse_sequence_rows(
        layout, fparams, pipe._new_stream(layout, rv),
        {k: jnp.asarray(v) for k, v in frames.items()}, sparams)
    out = pipe._exit_rows(layout, pipe._drop_carry(stream))
    return (np.asarray(out.num), np.asarray(out.weights),
            np.asarray(out.semkey))


def _run_port(cfg, frames, fparams, sparams):
    pcfg = Config(cfg)
    seg = SegmenterAdapter(adapnet_from_flax(*sparams,
                                             pcfg.SEMANTIC_2D_MODEL).eval())
    pipe = Pipeline(pcfg, segmenter=seg,
                    fusion_net=fusionnet_from_flax(*fparams,
                                                   pcfg.FUSION_MODEL),
                    device="cpu")
    vol = init_scene_volume(VSHAPE, ORIGIN, RES, 0.1, device="cpu")
    layout, rv = pipe._rows_from_volume(vol)
    stream = pipe.fuse_sequence_rows(
        layout, pipe._new_stream(layout, rv),
        {k: torch.as_tensor(v) for k, v in frames.items()})
    out = pipe._exit_rows(layout, stream.rv)
    return out.num.numpy(), out.weights.numpy(), out.semkey.numpy()


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    cfg = _config(1, 1, "float32")
    jpipe = JPipeline(cfg)
    dummy = {"tsdf_values": jnp.zeros((1, H, W, 9)),
             "tsdf_weights": jnp.zeros((1, H, W, 9)),
             "tsdf_frame": jnp.zeros((1, H, W, 1)),
             "semantic_frame": jnp.zeros((1, H, W, 1))}
    fparams = random_variables(jpipe.fusion_net, rng, dummy)
    adapnet = AdapNet(n_classes=30, stage=2)
    sparams = random_variables(adapnet, rng, jnp.zeros((1, H, W, 3)),
                               jnp.zeros((1, H, W, 3)))
    return fparams, sparams, adapnet


@pytest.mark.parametrize("frame_block,sem_every,geo_dtype,n_frames", [
    (1, 1, "float32", 5),       # the exact per-frame recurrence
    (4, 8, "bfloat16", 6),      # the headline settings (a padded block)
])
def test_slice_matches_jax(weights, frame_block, sem_every, geo_dtype,
                           n_frames):
    """Canonical weights/tsdf after the stream and the fused semantic ids.

    Tolerances: f32 geo -- weights within atol 1e-3 + rtol 1e-3 and tsdf
    within 1e-3 on voxels with weight > 0.05 (the nets' f32 summation
    order, re-fed through the recurrence); bf16 geo -- the
    tests/test_geo_bf16.py bounds (weights atol 0.1 + rtol 0.05 on >=
    99.99% of voxels and rtol 0.1 on all, tsdf atol 0.02). Semantic ids
    agree on >= 99% of observed voxels (argmax near-ties may flip on ~1e-6
    logit differences)."""
    fparams, sparams, adapnet = weights
    cfg = _config(frame_block, sem_every, geo_dtype)
    frames = _frames(n_frames)
    jn, jw, jk = _run_jax(cfg, frames, fparams, sparams, adapnet)
    tn, tw, tk = _run_port(cfg, frames, fparams, sparams)

    observed = jw > 0.05
    assert observed.sum() > 1000            # the stream did fuse
    if geo_dtype == "float32":
        np.testing.assert_allclose(tw, jw, atol=1e-3, rtol=1e-3)
        t_tol = 1e-3
    else:
        # bf16 sums random-walk with the add order: a voxel of weight ~100
        # (bf16 step 0.5) can drift further; hold 99.99% of voxels to the
        # bound and every voxel to rtol 0.1
        within = np.abs(tw - jw) <= 0.1 + 0.05 * np.abs(jw)
        assert within.mean() >= 0.9999, within.mean()
        np.testing.assert_allclose(tw, jw, atol=0.1, rtol=0.1)
        t_tol = 0.02
    np.testing.assert_allclose(tn[observed] / tw[observed],
                               jn[observed] / jw[observed], atol=t_tol)
    labelled = jk > 0
    assert labelled.sum() > 1000
    assert len(np.unique(jk[labelled] % 256)) > 1
    same = (tk[labelled] % 256) == (jk[labelled] % 256)
    assert same.mean() >= 0.99, same.mean()
    assert ((tk > 0) == labelled).mean() >= 0.999


def _small_data_config(frame_block=1):
    """tests/test_pipeline.py small_config: gt semantics, gf 2."""
    cfg = _merge_defaults(JConfig({}), _DEFAULTS)
    cfg.DATA.update(resx=24, resy=24, input="tof_depth", init_value=0.24,
                    semantics="class8", semantic_strategy="gt",
                    semantic_grid=True, n_frames=6, voxel_resolution=0.1,
                    noise_sigma=0.004, n_classes=8, n_scenes=2)
    cfg.FUSION_MODEL.update(n_points=5, n_tail_points=4, growth_factor=2,
                            use_semantics=False)
    cfg.SEMANTIC_2D_MODEL.n_classes = 8
    cfg.SETTINGS.update(frame_block=frame_block, rows_impl="xla")
    return cfg


def _batch(item):
    return {k: (np.asarray(v)[None] if isinstance(v, np.ndarray) else v)
            for k, v in item.items()} | {"frame_id": [item["frame_id"]]}


def test_fuse_many_matches_jax():
    """Two interleaved scenes with a padded tail chunk through both
    Databases. Same tolerances as the f32 slice; semantic keys exact (gt
    labels, score 1)."""
    cfg = _small_data_config()
    jdata = JSynthetic(cfg.DATA)
    pdata = Synthetic(Config(cfg).DATA, device="cpu")
    nf = cfg.DATA.n_frames
    idxs = [i for pair in zip(range(5), range(nf, nf + 5)) for i in pair]
    batches = [_batch(jdata[i]) for i in idxs]

    jdb = JDatabase(jdata, cfg.DATA)
    jpipe = JPipeline(cfg)
    dummy = {"tsdf_values": jnp.zeros((1, 24, 24, 5)),
             "tsdf_weights": jnp.zeros((1, 24, 24, 5)),
             "tsdf_frame": jnp.zeros((1, 24, 24, 1))}
    fparams = random_variables(jpipe.fusion_net, np.random.RandomState(3),
                               dummy)
    jpipe.fuse_many(batches, jdb, *fparams, chunk=4)

    pcfg = Config(cfg)
    db = Database(pdata, pcfg.DATA, device="cpu")
    assert db.scenes == jdb.scenes
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(*fparams,
                                                         pcfg.FUSION_MODEL),
                    device="cpu")
    pipe.fuse_many(batches, db, chunk=4)
    for s in jdb.scenes:
        jv, tv = jdb.volumes[s], db.volumes[s]
        assert tuple(tv.num.shape) == tuple(jv.num.shape)
        assert db.state[s]
        jw = np.asarray(jv.weights)
        np.testing.assert_allclose(tv.weights.numpy(), jw, atol=1e-3,
                                   rtol=1e-3)
        obs = jw > 0.05
        assert obs.sum() > 100
        np.testing.assert_allclose(
            tv.tsdf.numpy()[obs], np.asarray(jv.tsdf)[obs], atol=1e-3)
        np.testing.assert_array_equal(tv.semkey.numpy(),
                                      np.asarray(jv.semkey))


def test_synthetic_frames_match_jax():
    """The port's Synthetic (torch ray marcher) against the JAX one: the
    same rendering and labelling on >= 99% of pixels (depth within 1e-4;
    a lockstep sample landing on a rounding boundary may pick the
    neighbouring voxel)."""
    cfg = _small_data_config()
    cfg.DATA.n_scenes = 1
    jdata = JSynthetic(cfg.DATA)
    pdata = Synthetic(Config(cfg).DATA, device="cpu")
    for i in (0, 3):
        j, p = jdata[i], pdata[i]
        assert j["frame_id"] == p["frame_id"]
        np.testing.assert_array_equal(p["extrinsics"], j["extrinsics"])
        close = np.abs(p["depth_gt"] - j["depth_gt"]) <= 1e-4
        assert close.mean() >= 0.99
        assert (p["semantic_gt"] == j["semantic_gt"]).mean() >= 0.99


def test_scalar_integration_matches_jax():
    """SETTINGS.integration 'scalar' sends both Pipelines down the flat
    scalar path (row_path false; gather_precision f32 turns the packed
    gathers off): two interleaved scenes and a padded tail chunk through
    ``fuse_many`` (each chunk one flat ``fuse_sequence``), volumes as in
    test_fuse_many_matches_jax, keys exact. The row path stays the
    default."""
    cfg = _small_data_config()
    cfg.SETTINGS.update(integration="scalar", gather_precision="f32")
    nf = cfg.DATA.n_frames
    jdata = JSynthetic(cfg.DATA)
    idxs = [i for pair in zip(range(5), range(nf, nf + 5)) for i in pair]
    batches = [_batch(jdata[i]) for i in idxs]
    jdb, db, pipe, jpipe, seen = _fuse_many_pair(cfg, batches, chunk=4)
    assert not jpipe.row_path and not jpipe.packed16_gather
    assert not pipe.row_path and not pipe.packed16_gather
    assert not pipe.dirty_shadow
    assert seen["port"] == seen["jax"]
    for s in jdb.scenes:
        jw = np.asarray(jdb.volumes[s].weights)
        np.testing.assert_allclose(db.volumes[s].weights.numpy(), jw,
                                   atol=1e-3, rtol=1e-3)
        obs = jw > 0.05
        assert obs.sum() > 100
        np.testing.assert_allclose(db.volumes[s].tsdf.numpy()[obs],
                                   np.asarray(jdb.volumes[s].tsdf)[obs],
                                   atol=1e-3)
        np.testing.assert_array_equal(db.volumes[s].semkey.numpy(),
                                      np.asarray(jdb.volumes[s].semkey))
    cfg.SETTINGS.integration = "rows"
    assert JPipeline(cfg).row_path
    assert Pipeline(Config(cfg), device="cpu").row_path


def _fuse_many_pair(cfg, batches, chunk):
    """The same batches through JAX and port ``fuse_many`` with the same
    seeded FusionNet; returns both Databases, the port's Pipeline and, per
    side, the scene ids in the order ``Database.update`` saw them."""
    jdata = JSynthetic(cfg.DATA)
    pdata = Synthetic(Config(cfg).DATA, device="cpu")
    jdb = JDatabase(jdata, cfg.DATA)
    jpipe = JPipeline(cfg)
    dummy = {"tsdf_values": jnp.zeros((1, 24, 24, 5)),
             "tsdf_weights": jnp.zeros((1, 24, 24, 5)),
             "tsdf_frame": jnp.zeros((1, 24, 24, 1))}
    fparams = random_variables(jpipe.fusion_net, np.random.RandomState(3),
                               dummy)
    pcfg = Config(cfg)
    db = Database(pdata, pcfg.DATA, device="cpu")
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(*fparams,
                                                         pcfg.FUSION_MODEL),
                    device="cpu")
    seen = {"jax": [], "port": []}
    for side, d in (("jax", jdb), ("port", db)):
        update = d.update

        def record(scene_id, volume, update=update, side=side):
            seen[side].append(scene_id)
            update(scene_id, volume)
        d.update = record
    jpipe.fuse_many(batches, jdb, *fparams, chunk=chunk)
    pipe.fuse_many(batches, db, chunk=chunk)
    return jdb, db, pipe, jpipe, seen


def test_env_overrides_match_jax(monkeypatch):
    """SEGFUSION_FRAME_BLOCK / SEGFUSION_GEO_DTYPE override the config in
    both packages: 4-frame blocks into bf16 geo state. Volumes within the
    bf16 bounds of test_slice_matches_jax (weights atol 0.1 + rtol 0.05,
    tsdf atol 0.02 on observed voxels)."""
    monkeypatch.setenv("SEGFUSION_FRAME_BLOCK", "4")
    monkeypatch.setenv("SEGFUSION_GEO_DTYPE", "bfloat16")
    cfg = _small_data_config()
    cfg.DATA.n_scenes = 1
    batches = [_batch(JSynthetic(cfg.DATA)[i]) for i in range(6)]
    jdb, db, pipe, jpipe, _ = _fuse_many_pair(cfg, batches, chunk=4)
    assert jpipe.frame_block == pipe.frame_block == 4
    assert jpipe.geo_dtype == jnp.bfloat16
    assert pipe.geo_dtype == torch.bfloat16
    for s in jdb.scenes:
        jw = np.asarray(jdb.volumes[s].weights)
        tw = db.volumes[s].weights.numpy()
        np.testing.assert_allclose(tw, jw, atol=0.1, rtol=0.05)
        obs = jw > 0.05
        assert obs.sum() > 100
        np.testing.assert_allclose(db.volumes[s].tsdf.numpy()[obs],
                                   np.asarray(jdb.volumes[s].tsdf)[obs],
                                   atol=0.02)


def test_max_live_row_scenes_matches_jax():
    """SETTINGS.max_live_row_scenes: 2 keeps both interleaved scenes'
    slot states live in both packages: each scene is written back to the
    Database once, at the end, in the same order (with 1, every chunk of
    the other scene evicts it). Volumes as in test_fuse_many_matches_jax."""
    cfg = _small_data_config()
    cfg.SETTINGS.max_live_row_scenes = 2
    nf = cfg.DATA.n_frames
    jdata = JSynthetic(cfg.DATA)
    idxs = [i for pair in zip(range(5), range(nf, nf + 5)) for i in pair]
    batches = [_batch(jdata[i]) for i in idxs]
    jdb, db, _, _, seen = _fuse_many_pair(cfg, batches, chunk=2)
    assert seen["jax"] == jdb.scenes
    assert seen["port"] == seen["jax"]
    for s in jdb.scenes:
        jw = np.asarray(jdb.volumes[s].weights)
        np.testing.assert_allclose(db.volumes[s].weights.numpy(), jw,
                                   atol=1e-3, rtol=1e-3)
        obs = jw > 0.05
        assert obs.sum() > 100
        np.testing.assert_allclose(db.volumes[s].tsdf.numpy()[obs],
                                   np.asarray(jdb.volumes[s].tsdf)[obs],
                                   atol=1e-3)
