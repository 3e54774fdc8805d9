"""Port parity for scene-parallel fusion: the port's
``SceneParallelFusion`` (``run``, one step a frame, and ``run_sequences``,
whole streams) against the JAX package's on the conftest's CPU devices,
from the same Flax weights, and against the port's own scene-by-scene
fusion; on the row path, with frame blocks, bf16 geo and semantic
decimation, and on the flat scalar path. Then the folded plain kernels
against the JAX interpret-mode ``*_pallas_v`` entry points under
``jax.vmap`` (an unbatched carry too), ``_fit_mesh``, the stack/unstack
round trip, and a sample past a scene's last x-plane, which must stay in
its own scene.

Tolerances as in tests/test_scene_parallel.py (weights 1e-4, num 1e-3,
semkey exact) against JAX. With one scene a device the port's runner
equals its own scene-by-scene fusion bit for bit on the CPU (each scatter
keeps the per-scene order of its updates); scenes that share a device
share the net's batch, which the CPU's convolutions sum in another order,
so they are held to the bounds above.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.ops.pallas import shadow_build as jsb
from segfusion_tpu.parallel import scene_parallel as jsp
from segfusion_tpu.parallel.mesh import scene_mesh as jscene_mesh
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import init_scene_volume
from segfusion_tpu_torch.ops import rowvol
from segfusion_tpu_torch.ops.kernels import shadow_build as sb
from segfusion_tpu_torch.parallel import (SceneParallelFusion, scene_mesh,
                                          shard_batch, stack_volumes,
                                          unstack_volumes)
from tests.test_pipeline import _batch, small_config
from tests.test_shadow_pallas import _reachable_geo
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax

N_FRAMES = 3
CPU2 = ["cpu", "cpu"]


def _jax_config(integration="rows", **settings):
    cfg = small_config(use_semantics=False, semantics="class8")
    cfg.DATA.semantic_grid = True
    cfg.DATA.n_scenes = 2
    cfg.SETTINGS.update(integration=integration, **settings)
    return cfg


@pytest.fixture(scope="module")
def data():
    cfg = _jax_config()
    jdata = JSynthetic(cfg.DATA)
    jpipe = JPipeline(cfg)
    params, stats = jpipe.init_fusion_params(jax.random.PRNGKey(0), 48, 48)
    streams = [[jpipe._frame_from_batch(
        _batch(jdata, si * cfg.DATA.n_frames + t), cfg.DATA.input)
        for t in range(N_FRAMES + 2)] for si in range(2)]
    return jdata, params, stats, streams


def _port(cfg, params, stats, jdata):
    pcfg = Config(copy.deepcopy(cfg))
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(
        params, stats, pcfg.FUSION_MODEL), device="cpu")
    return pipe, Database(jdata, pcfg.DATA, device="cpu")


def _close(port_vols, jax_vols):
    for v, j in zip(port_vols, jax_vols):
        np.testing.assert_allclose(v.weights.numpy(), np.asarray(j.weights),
                                   atol=1e-4)
        np.testing.assert_allclose(v.num.numpy(), np.asarray(j.num),
                                   atol=1e-3)
        np.testing.assert_array_equal(v.semkey.numpy(),
                                      np.asarray(j.semkey))


def _equal(a_vols, b_vols):
    for a, b in zip(a_vols, b_vols):
        for x, y in ((a.num, b.num), (a.weights, b.weights),
                     (a.semkey, b.semkey)):
            assert torch.equal(x, y)


def _observed(vols):
    for v in vols:
        assert int((v.weights > 0.05).sum()) > 100
        assert int((v.semkey > 0).sum()) > 100


@pytest.mark.parametrize("integration", ["rows", "scalar"])
def test_run_matches_jax_and_scene_by_scene(data, integration):
    """``run`` (one folded step a frame) on two CPU "devices" against the
    JAX runner on two CPU devices and the port's per-scene
    ``step_fuse_impl`` loop."""
    jdata, params, stats, streams = data
    streams = [s[:N_FRAMES] for s in streams]
    cfg = _jax_config(integration)
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    jout = jsp.SceneParallelFusion(
        jpipe, jscene_mesh(devices=jax.devices()[:2])).run(
            (params, stats), [jdb.volumes[s] for s in jdata.scenes], streams)

    pipe, db = _port(cfg, params, stats, jdata)
    runner = SceneParallelFusion(pipe, scene_mesh(devices=CPU2))
    out = runner.run([db.volumes[s] for s in jdata.scenes], streams)
    assert runner.mesh.size == 2
    _observed(out)
    _close(out, jout)

    db.reset()
    seq = []
    for si, s in enumerate(jdata.scenes):
        v = db.volumes[s]
        for f in streams[si]:
            v = pipe.step_fuse_impl(v, {k: torch.as_tensor(x)[None]
                                        for k, x in f.items()})
        seq.append(v)
    _equal(out, seq)


def _stacked_frames(streams, n):
    return {k: torch.as_tensor(np.stack([np.stack([np.asarray(f[k])
                                                   for f in st[:n]])
                                         for st in streams]))
            for k in streams[0][0]}


def _run_sequences(data, integration, settings, n):
    """(the port's folded volumes, the JAX runner's, the port's
    scene-by-scene ``fuse_sequence``) of n frames a scene."""
    jdata, params, stats, streams = data
    cfg = _jax_config(integration, **settings)
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    jrunner = jsp.SceneParallelFusion(jpipe,
                                      jscene_mesh(devices=jax.devices()[:2]))
    frames = _stacked_frames(streams, n)
    jout = jsp.unstack_volumes(jrunner.run_sequences(
        (params, stats), jrunner.shard_volumes(jsp.stack_volumes(
            [jdb.volumes[s] for s in jdata.scenes])),
        {k: jnp.asarray(v.numpy()) for k, v in frames.items()}, None), 2)

    pipe, db = _port(cfg, params, stats, jdata)
    assert pipe.frame_block == settings.get("frame_block", 1)
    runner = SceneParallelFusion(pipe, scene_mesh(devices=CPU2))
    out = unstack_volumes(runner.run_sequences(
        stack_volumes([db.volumes[s] for s in jdata.scenes]), frames), 2)
    db.reset()
    seq = [pipe.fuse_sequence(db.volumes[s], {k: v[si]
                                              for k, v in frames.items()})
           for si, s in enumerate(jdata.scenes)]
    return out, jout, seq


@pytest.mark.parametrize("integration,settings", [
    ("rows", {}),
    ("rows", {"frame_block": 4, "sem_integrate_every": 2}),
    ("scalar", {})])
def test_run_sequences_matches_jax_and_scene_by_scene(data, integration,
                                                      settings):
    """``run_sequences`` (whole (S, T) streams; the row path streams with
    the dirty carry) against the JAX runner and the port's per-scene
    ``fuse_sequence``. The frame-block case has 5 frames (a padded tail
    block) and integrates semantics every other block."""
    out, jout, seq = _run_sequences(data, integration, settings,
                                    5 if settings else N_FRAMES)
    _observed(out)
    _close(out, jout)
    _equal(out, seq)


def test_run_sequences_bf16_geo_frame_blocks(data):
    """frame_block 4, bf16 geo, semantics every other block, 5 frames
    (the multi-scene streaming settings of
    tests/test_frame_block.py::test_scene_parallel_vmap_composes with the
    headline's geo dtype): the folded run equals the port's scene-by-scene
    one bit for bit, and tracks its own f32-geo run -- which matches the
    JAX runner within the f32 bounds above -- within
    tests/test_geo_bf16.py's bounds (weights atol 0.1 + rtol 0.05, tsdf
    atol 0.02, keys exact). The JAX runner's bf16 run is no reference
    here: a bf16 sum rounds in its add order, and on this stream XLA's
    order leaves one voxel at weight 16.74 where the f32 run has 20.27
    (the port's bf16: 20.24)."""
    settings = {"frame_block": 4, "sem_integrate_every": 2}
    out, _, seq = _run_sequences(data, "rows",
                                 dict(settings, geo_dtype="bfloat16"), 5)
    _observed(out)
    _equal(out, seq)
    f32, jf32, _ = _run_sequences(data, "rows", settings, 5)
    _close(f32, jf32)
    for b, f in zip(out, f32):
        np.testing.assert_array_equal(b.semkey.numpy(), f.semkey.numpy())
        np.testing.assert_allclose(b.weights.numpy(), f.weights.numpy(),
                                   atol=0.1, rtol=0.05)
        obs = f.weights > 0.05
        np.testing.assert_allclose((b.num / b.weights)[obs].numpy(),
                                   (f.num / f.weights)[obs].numpy(),
                                   atol=0.02)


def test_one_device_folds_both_scenes(data, monkeypatch):
    """On a one-device mesh the two scenes run as one group: each stream
    step is one folded shadow build, the exit one reconcile of each kind,
    and the result is the two-device one within the bounds above (the net
    now runs over two frames at once, and the CPU's convolutions sum a
    batch of two in another order than one frame)."""
    jdata, params, stats, streams = data
    cfg = _jax_config()
    pipe, db = _port(cfg, params, stats, jdata)
    frames = _stacked_frames(streams, N_FRAMES)
    calls = []
    for name in ("build_shadow_dirty", "reconcile_slot", "reconcile_key"):
        fn = getattr(sb, name)

        def counted(*a, name=name, fn=fn, **kw):
            calls.append((name, a[3] if name == "build_shadow_dirty"
                          else a[1]))
            return fn(*a, **kw)
        monkeypatch.setattr(sb, name, counted)
    one = SceneParallelFusion(pipe, scene_mesh(devices=["cpu"]))
    out = unstack_volumes(one.run_sequences(stack_volumes(
        [db.volumes[s] for s in jdata.scenes]), frames), 2)
    names = [c[0] for c in calls]
    assert names == ["build_shadow_dirty"] * N_FRAMES + ["reconcile_slot",
                                                         "reconcile_key"]
    L = rowvol.RowLayout.for_shape(tuple(out[0].num.shape))
    assert all(layout.X == 2 * L.X for _, layout in calls)
    db.reset()
    two = SceneParallelFusion(pipe, scene_mesh(devices=CPU2))
    _close(out, [SimpleNamespace(**{k: getattr(v, k).numpy() for k in (
        "num", "weights", "semkey")}) for v in unstack_volumes(
            two.run_sequences(stack_volumes(
                [db.volumes[s] for s in jdata.scenes]), frames), 2)])


def test_sample_past_last_x_plane_stays_in_its_scene():
    """A sample in scene 0's last x-plane whose x-corner 1 lies one past
    it, and one past the plane (both x-corners outside): the folded corner
    rows mask the outside corners and keep their clamped rows in scene 0,
    and the folded integration writes nothing into scene 1."""
    L = rowvol.RowLayout.for_shape((6, 8, 40))
    X = L.X
    pts = torch.tensor([[[X - 0.7, 3.2, 5.5]], [[X + 0.3, 3.2, 5.5]]],
                       dtype=torch.float32)                     # (2, 1, 3)
    points = torch.stack([pts, pts + torch.tensor([0.0, 1.0, 2.0])])
    points[1, :, :, 0] = 2.5         # scene 1's samples well inside
    cr = rowvol.corner_rows_scenes(points, L)
    assert cr.sg_rows.shape == (2, 4, 1)
    single = rowvol.corner_rows(pts, L)
    for c in range(2):
        assert torch.equal(cr.vx[c, :2], single.vx[c])
        assert torch.equal(cr.sg_rows[c, :2], single.sg_rows[c])
    assert not bool(cr.vx[1, 0, 0]) and not bool(cr.vx[:, 1].any())
    assert int(cr.sg_rows[:, :2].max()) < L.geo_rows
    assert int(cr.k_rows[:, :2].max()) < L.key_rows
    geo = torch.zeros((2 * L.geo_rows, 128))
    key = torch.zeros((2 * L.key_rows, 128), dtype=torch.int32)
    rowvol.integrate_rows(geo, key, cr, torch.full((4, 1), 0.05),
                          torch.full((4,), 7, dtype=torch.int32),
                          torch.tensor([True, True, False, False]), 1)
    assert bool((geo[:L.geo_rows] != 0).any())
    assert not bool((geo[L.geo_rows:] != 0).any())
    assert not bool((key[L.key_rows:] != 0).any())


def test_scene_edge_stream_leaves_the_next_scene_untouched(data):
    """End to end: scene 0 sees its stream, scene 1 an all-masked one
    (no-op frames). Scene 1's volume stays empty, and scene 0's matches
    its own single-scene fusion (the bounds above: the net runs over both
    scenes' frames), although its rays reach past its x extent into where
    scene 1's rows begin."""
    jdata, params, stats, streams = data
    cfg = _jax_config()
    pipe, db = _port(cfg, params, stats, jdata)
    frames = _stacked_frames(streams, N_FRAMES)
    frames["mask"][1] = False
    s0 = jdata.scenes[0]
    ref = pipe.fuse_sequence(db.volumes[s0], {k: v[0]
                                               for k, v in frames.items()})
    layout = rowvol.RowLayout.for_shape(tuple(ref.num.shape))
    pts = []
    orig = pipe._row_frontend

    def spy(layout, rv, fr, *a, **kw):
        out = orig(layout, rv, fr, *a, **kw)
        pts.append(out[0].vx)
        return out
    pipe._row_frontend = spy
    pipe.fuse_sequence(db.volumes[s0], {k: v[0] for k, v in frames.items()})
    assert any(bool((~vx).any()) for vx in pts)      # corners past x
    db.reset()
    out = unstack_volumes(SceneParallelFusion(
        pipe, scene_mesh(devices=["cpu"])).run_sequences(
            stack_volumes([db.volumes[s0], db.volumes[s0]]), frames), 2)
    assert layout.X == out[1].num.shape[0]
    assert not bool(out[1].weights.any()) and not bool(out[1].semkey.any())
    _close(out[:1], [SimpleNamespace(num=ref.num.numpy(),
                                     weights=ref.weights.numpy(),
                                     semkey=ref.semkey.numpy())])


def test_fit_mesh_regrows_after_small_batch(data):
    jdata, params, stats, _ = data
    pipe, _ = _port(_jax_config(), params, stats, jdata)
    sp = SceneParallelFusion(pipe, scene_mesh(devices=["cpu"] * 8))
    assert sp.mesh.size == 8
    sp._fit_mesh(2)
    assert sp.mesh.size == 2
    sp._fit_mesh(8)
    assert sp.mesh.size == 8
    sp._fit_mesh(6)
    assert sp.mesh.size == 6
    sp._fit_mesh(7)
    assert sp.mesh.size == 7


def test_stack_unstack_roundtrip():
    vols = [init_scene_volume((8, 8, 8), np.full(3, float(i), np.float32),
                              0.1 * (i + 1), device="cpu") for i in range(3)]
    for i, v in enumerate(vols):
        v.num.fill_(i)
    stacked = stack_volumes(vols)
    assert stacked.num.shape == (3, 8, 8, 8)
    assert stacked.origin.shape == (3, 3)
    assert stacked.resolution.shape == (3,)
    back = unstack_volumes(stacked, 3)
    assert back[1].num.shape == (8, 8, 8)
    assert float(back[2].num[0, 0, 0]) == 2.0
    assert float(back[1].resolution) == pytest.approx(0.2)
    groups = shard_batch(scene_mesh(devices=["cpu"] * 3), stacked)
    assert len(groups) == 3 and groups[1].num.shape == (1, 8, 8, 8)
    assert [float(v.origin[0]) for v in unstack_volumes(groups, 3)] == \
        [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        stack_volumes([vols[0], init_scene_volume((8, 8, 4), np.zeros(3),
                                                  0.1, device="cpu")])


# -- the folded plain kernels against the JAX custom_vmap rules -------------

class TestFoldedKernels:
    L = rowvol.RowLayout.for_shape((6, 8, 40))
    S = 3

    def _geo(self, seed):
        g = _reachable_geo(self.L, np.random.RandomState(seed), batch=self.S)
        return np.asarray(g)

    def test_build_shadow_and_reconciles(self):
        L, S = self.L, self.S
        geo = self._geo(21)
        key = np.random.RandomState(22).randint(
            0, 2 ** 31 - 1, (S, L.key_rows, 128), dtype=np.int32)
        want = jax.vmap(lambda g: jsb.build_shadow_pallas_v(
            g, L, interpret=True))(jnp.asarray(geo))
        got = rowvol.build_shadow_v(torch.as_tensor(geo), L)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).view(np.int32))
        wn, ww = jax.vmap(lambda g: jsb.reconcile_slot_pallas_v(
            g, L, interpret=True))(jnp.asarray(geo))
        wk = jax.vmap(lambda k: jsb.reconcile_key_pallas_v(
            k, L, interpret=True))(jnp.asarray(key))
        num, w, k = rowvol.volumes_from_rows(torch.as_tensor(geo),
                                             torch.as_tensor(key), L)
        np.testing.assert_array_equal(num.numpy(), np.asarray(wn))
        np.testing.assert_array_equal(w.numpy(), np.asarray(ww))
        np.testing.assert_array_equal(k.numpy(), np.asarray(wk))
        # each scene's slice is the single-scene kernel's result
        for s in range(S):
            assert torch.equal(got[s], sb.build_shadow(
                torch.as_tensor(geo[s]), L, rowvol.shadow_tiling(L)[0]))

    @pytest.mark.parametrize("batched_carry", [False, True])
    def test_build_shadow_dirty(self, batched_carry):
        """geo batched; prev_shadow and dirty batched, or unbatched (the
        fresh carry of a scene stream, the multi512 case)."""
        L, S = self.L, self.S
        rng = np.random.RandomState(23)
        geo = self._geo(24)
        _, NJ = rowvol.shadow_tiling(L)
        nt = L.X * NJ
        if batched_carry:
            prev = rng.randint(0, 2 ** 32, (S, L.shadow_rows, 128),
                               dtype=np.uint32)
            dirty = np.zeros((S, nt + 1), np.int32)
            dirty[:, ::2] = 1
            dirty[1, 1::3] = 1
            jfn = jax.vmap(lambda g, p, d: jsb.build_shadow_dirty_pallas_v(
                g, p, d, L, interpret=True))
            want = jfn(jnp.asarray(geo), jnp.asarray(prev),
                       jnp.asarray(dirty))
        else:
            prev = np.zeros((L.shadow_rows, 128), np.uint32)
            dirty = np.concatenate([np.ones(nt, np.int32),
                                    np.zeros(1, np.int32)])
            want = jax.vmap(lambda g: jsb.build_shadow_dirty_pallas_v(
                g, jnp.asarray(prev), jnp.asarray(dirty), L,
                interpret=True))(jnp.asarray(geo))
        tprev = torch.as_tensor(prev.view(np.int32).copy())
        got = rowvol.build_shadow_dirty_v(torch.as_tensor(geo), tprev,
                                          torch.as_tensor(dirty), L)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).view(np.int32))
        if batched_carry:
            assert got.data_ptr() == tprev.data_ptr()     # in place
        else:
            assert got.shape == (S, L.shadow_rows, 128)
            assert not bool(tprev.any())                  # left as it was

    def test_dirty_needs_a_scene_axis(self):
        L = self.L
        _, NJ = rowvol.shadow_tiling(L)
        with pytest.raises(ValueError, match="scene axis"):
            rowvol.build_shadow_dirty_v(
                torch.zeros((L.geo_rows, 128)),
                torch.zeros((L.shadow_rows, 128), dtype=torch.int32),
                torch.ones(L.X * NJ + 1, dtype=torch.int32), L)
