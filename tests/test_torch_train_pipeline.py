"""Port parity for the training slice: ``Pipeline.train_sequence_rows``
(slot-row state, packed gt shadow, FusionNet v3 in train mode, summed
gradients, resets) against the JAX package's ``train_sequence_rows`` on
the same numpy frames, on the CPU at a small size (44x48x44 volume, 32x32
frames, 4 frames, one reset). ``train_fusion`` end to end is in
tests/test_torch_checkpoints.py.

The JAX pipeline's float32 training numerics are noisy: at batch 1 many
BatchNorm channels of the first frames are nearly constant over the image
(an empty volume extracts the same values along most rays), so Flax's
``mean(x^2) - mean^2`` cancels and ``rsqrt(var + eps)`` amplifies the
rounding. Against a float64 evaluation of the JAX package's own loss
(Flax ``apply(train=True)``, ``_fused_for_loss``, ``fusion_loss``) on the
same net inputs, the JAX pipeline's gradients are 0.029 off (of 2.1) and
its estimates ~1e-3; the port's are 6e-4 and 6e-5. So the gradients and
estimates are held to that float64 reference, and to the JAX pipeline
within the JAX pipeline's own distance from it.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.config import Config as JConfig, _DEFAULTS, _merge_defaults
from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.core.pipeline import _fused_for_loss as j_fused_for_loss
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.utils.losses import fusion_loss as j_fusion_loss
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.data.synthetic import Synthetic
from segfusion_tpu_torch.ops import rowvol
from segfusion_tpu_torch.utils.convert import (flax_tree, fusionnet_from_flax,
                                               to_flax)
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

H = W = 32
P = 5
leaves = jax.tree_util.tree_leaves
RESETS = np.array([False, False, True, False])


def _config():
    cfg = _merge_defaults(JConfig({}), _DEFAULTS)
    cfg.DATA.update(resx=W, resy=H, input="tof_depth", init_value=0.24,
                    semantics="class8", semantic_strategy="gt",
                    semantic_grid=False, n_frames=6, voxel_resolution=0.1,
                    noise_sigma=0.004, n_classes=8, n_scenes=1)
    cfg.FUSION_MODEL.update(n_points=P, n_tail_points=4, growth_factor=2,
                            use_semantics=True, dropout=0.0)
    cfg.SEMANTIC_2D_MODEL.n_classes = 8
    cfg.SETTINGS.update(rows_impl="xla")
    return cfg


def _batch(item):
    return {k: (np.asarray(v)[None] if isinstance(v, np.ndarray) else v)
            for k, v in item.items()} | {"frame_id": [item["frame_id"]]}


@pytest.fixture(scope="module")
def setup():
    cfg = _config()
    jdata = JSynthetic(cfg.DATA)
    jpipe = JPipeline(cfg)
    dummy = {k: jnp.zeros((1, H, W, c)) for k, c in (
        ("tsdf_values", P), ("tsdf_weights", P), ("tsdf_frame", 1),
        ("semantic_frame", 1))}
    params, stats = random_variables(jpipe.fusion_net,
                                     np.random.RandomState(0), dummy)
    frames = [jpipe._frame_from_batch(_batch(jdata[i]), cfg.DATA.input)
              for i in range(4)]
    frames = {k: np.stack([np.asarray(f[k]) for f in frames])
              for k in frames[0]}
    return cfg, jdata, jpipe, params, stats, frames


def _run_jax(cfg, jdata, jpipe, params, stats, frames):
    jdb = JDatabase(jdata, cfg.DATA)
    s = jdata.scenes[0]
    layout, rv = jpipe._rows_from_volume(jdb.volumes[s])
    gt_shadow = jpipe._gt_shadow(layout, jdb.scenes_gt[s])
    loss, grads, stream, new_stats = jpipe.train_sequence_rows(
        layout, params, stats, jpipe._new_stream(layout, rv), gt_shadow,
        {k: jnp.asarray(v) for k, v in frames.items()}, None,
        jax.random.split(jax.random.PRNGKey(0), len(RESETS)),
        jnp.asarray(RESETS))
    out = jpipe._exit_rows(layout, jpipe._drop_carry(stream))
    return float(loss), grads, out, new_stats


def _port_pipeline(cfg, params, stats, dirty):
    pcfg = Config(copy.deepcopy(cfg))
    pcfg.SETTINGS.dirty_shadow = "on" if dirty else "off"
    data = Synthetic(pcfg.DATA, device="cpu")
    db = Database(data, pcfg.DATA, device="cpu")
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(
        params, stats, pcfg.FUSION_MODEL), device="cpu", train=True)
    return pipe, db, data.scenes[0]


def _run_port(cfg, params, stats, frames, dirty):
    """The port's train_sequence_rows (dirty carry on) or train_sequence
    (off: the canonical entry and exit); per frame the net inputs, the
    gt values and the estimate it used."""
    pipe, db, s = _port_pipeline(cfg, params, stats, dirty)
    seen, ests = [], []
    frontend = pipe._row_frontend

    def spy(*args, **kw):
        out = frontend(*args, **kw)
        seen.append(out)
        return out
    pipe._row_frontend = spy
    pipe.fusion_net.register_forward_hook(
        lambda m, i, o: ests.append(o.detach()))
    layout = rowvol.RowLayout.for_shape(tuple(db.volumes[s].num.shape))
    gt_shadow = pipe._gt_shadow(layout, db.scenes_gt[s])
    tframes = {k: torch.as_tensor(v) for k, v in frames.items()}
    if dirty:
        _, rv = pipe._rows_from_volume(db.volumes[s])
        loss, stream = pipe.train_sequence_rows(
            layout, pipe._new_stream(layout, rv), gt_shadow, tframes,
            torch.as_tensor(RESETS))
        out = pipe._exit_rows(layout, stream.rv)
    else:
        loss, out = pipe.train_sequence(db.volumes[s], db.scenes_gt[s],
                                        tframes, torch.as_tensor(RESETS))
    net = pipe.fusion_net
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    inputs = [(inp, fv, fw, rowvol.extract_rows(gt_shadow, cr, 0.24, -0.1)[0],
               mask) for cr, fv, fw, inp, mask, _ in seen]
    return float(loss), grads, out, to_flax(net)[1], inputs, ests


def _reference_f64(jpipe, params, stats, inputs):
    """The JAX package's per-frame loss in float64 on the port's net
    inputs, BatchNorm statistics carried: (loss sum, summed grads, new
    stats, estimates)."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)

        @jax.jit
        def frame(p, st, inp, fv, fw, gv, mask):
            def loss_fn(p):
                out, mut = jpipe.fusion_net.apply(
                    {"params": p, "batch_stats": st}, inp, train=True,
                    mutable=["batch_stats"])
                est = out[..., :P].reshape(1, -1, P)
                fused = j_fused_for_loss(fv, fw, est, 0.24)
                return j_fusion_loss(fused, gv[None, :, :P], mask[None]), (
                    mut["batch_stats"], est)
            return jax.value_and_grad(loss_fn, has_aux=True)(p)

        p64, st = f64(params), f64(stats)
        total, gsum, ests = 0.0, None, []
        for inp, fv, fw, gv, mask in inputs:
            (loss, (st, est)), g = frame(
                p64, st, f64({k: v.numpy() for k, v in inp.items()}),
                f64(fv.numpy()), f64(fw.numpy()), f64(gv.numpy()),
                jnp.asarray(mask.numpy()))
            total += float(loss)
            gsum = g if gsum is None else jax.tree_util.tree_map(
                jnp.add, gsum, g)
            ests.append(np.asarray(est))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        return total, host(gsum), host(st), ests


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(leaves(a), leaves(b)))


def test_train_sequence_rows_matches_jax(setup):
    """4 frames, a reset before the third, the dirty carry on and off.

    Tolerances: carry on and off bit-identical (as in the JAX package);
    against the JAX pipeline, the loss sum within 1e-3 (its test's
    5e-3; measured 1.2e-4), the new running statistics and the weights
    within 1e-4, the tsdf within 2e-3 where the weight exceeds 0.05 (the
    JAX estimates' noise; measured 1.1e-3), the gradients no farther from
    JAX's than JAX's are from the float64 reference, plus 5e-3; against
    the float64 reference, the loss within rtol 1e-5, the gradients within
    5e-3 (measured 6.2e-4), the estimates within 1e-4 (6e-5), the
    statistics within 1e-5."""
    cfg, jdata, jpipe, params, stats, frames = setup
    jl, jg, jout, jstats = _run_jax(cfg, jdata, jpipe, params, stats,
                                    frames)
    loss, grads, out, new_stats, inputs, ests = _run_port(
        cfg, params, stats, frames, dirty=True)
    loss_off, grads_off, out_off, _, _, _ = _run_port(
        cfg, params, stats, frames, dirty=False)
    assert loss_off == loss
    assert _max_err(grads_off, grads) == 0.0
    assert torch.equal(out_off.num, out.num)
    assert torch.equal(out_off.weights, out.weights)

    ref_loss, ref_grads, ref_stats, ref_ests = _reference_f64(
        jpipe, params, stats, inputs)
    assert len(inputs) == len(RESETS)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert abs(loss - jl) <= 1e-3
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(ref_grads)
    assert _max_err(grads, ref_grads) <= 5e-3
    assert _max_err(grads, jg) <= _max_err(jg, ref_grads) + 5e-3
    for est, ref in zip(ests, ref_ests):
        np.testing.assert_allclose(est[..., :P].numpy().reshape(ref.shape),
                                   ref, atol=1e-4)
    assert _max_err(new_stats, ref_stats) <= 1e-5
    assert _max_err(new_stats, jstats) <= 1e-4
    assert _max_err(new_stats, stats) > 1e-3

    jw = np.asarray(jout.weights)
    np.testing.assert_allclose(out.weights.numpy(), jw, atol=1e-4)
    obs = jw > 0.05
    assert obs.sum() > 1000
    np.testing.assert_allclose(out.tsdf.numpy()[obs],
                               np.asarray(jout.tsdf)[obs], atol=2e-3)


def test_padded_frame_adds_no_gradient_but_moves_statistics(setup):
    """An all-masked padding frame (the tail of a short chunk) adds zero
    gradient and integrates nothing, but runs the net in train mode, so
    the BatchNorm running statistics move."""
    cfg, _, _, params, stats, frames = setup
    short = {k: torch.as_tensor(v[:2]) for k, v in frames.items()}
    padded = {k: torch.cat([x, x[-1:]]) for k, x in short.items()}
    padded["mask"][2:] = False
    results = []
    for fr in (short, padded):
        pipe, db, s = _port_pipeline(cfg, params, stats, dirty=True)
        layout, rv = pipe._rows_from_volume(db.volumes[s])
        gt = pipe._gt_shadow(layout, db.scenes_gt[s])
        loss, stream = pipe.train_sequence_rows(
            layout, pipe._new_stream(layout, rv), gt, fr,
            torch.zeros(fr["depth"].shape[0], dtype=torch.bool))
        net = pipe.fusion_net
        results.append((float(loss), {n: p.grad.clone() for n, p in
                                      net.named_parameters()},
                        to_flax(net)[1], stream.rv.geo.clone()))
    (l2, g2, s2, geo2), (l3, g3, s3, geo3) = results
    assert l3 == l2
    assert all(torch.equal(g3[n], g2[n]) for n in g2)
    assert torch.equal(geo3, geo2)
    assert _max_err(s3, s2) > 1e-4
