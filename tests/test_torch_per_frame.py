"""Port parity for the per-frame step and the flat scalar path:
``Pipeline.fuse`` (row path and ``SETTINGS.integration: scalar`` in both
``gather_precision`` settings), flat ``fuse_sequence``, ``fuse_training``
and flat ``train_sequence`` against the JAX package's, on the CPU at a
44x48x44 volume with 32x32 frames (FusionNet v3 gf 2 with the semantic
input, gt labels, dropout 0), the JAX Synthetic frames on both sides.

Bounds are those of ``tests/test_rowvol.py:201-203`` (the row path
against the flat one: num and w within atol 1e-4 + rtol 1e-4, keys
exact) and ``tests/test_train_sequence.py:104-110`` (loss and gradients
within 5e-3, volumes and BatchNorm statistics within 1e-4), or tighter
where stated. The training gradients are also held to a float64
evaluation of the JAX package's loss on the port's own net inputs, and to
the JAX pipeline within its own distance from that reference (its f32
gradients are noisy at batch 1: ``tests/test_torch_train_pipeline.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.core.database import Database as JDatabase
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.database import Database
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.ops import rowvol
from segfusion_tpu_torch.utils.convert import (flax_tree, fusionnet_from_flax,
                                               to_flax)
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_train_pipeline import (RESETS, _batch, _max_err,
                                             _reference_f64, setup)  # noqa

leaves = jax.tree_util.tree_leaves
N_FRAMES = 4


def _configure(cfg, integration, gather="f16packed"):
    cfg = copy.deepcopy(cfg)
    cfg.SETTINGS.update(integration=integration, gather_precision=gather)
    return cfg


def _volumes(db, scene):
    v = db.volumes[scene]
    return (np.asarray(v.num), np.asarray(v.weights), np.asarray(v.semkey))


def _port(cfg, params, stats, jdata, train=False):
    pcfg = Config(copy.deepcopy(cfg))
    pipe = Pipeline(pcfg, fusion_net=fusionnet_from_flax(
        params, stats, pcfg.FUSION_MODEL), device="cpu", train=train)
    return pipe, Database(jdata, pcfg.DATA, device="cpu")


@pytest.mark.parametrize("integration,gather", [
    ("rows", "f16packed"), ("scalar", "f16packed"), ("scalar", "f32")])
def test_fuse_matches_jax(setup, integration, gather, monkeypatch):
    """Four ``fuse`` calls with semantics, the port against the JAX
    package's per-frame ``fuse`` in the same setting: num and w within
    atol 1e-4 + rtol 1e-4 (measured <= 3e-7), keys exact. The row path
    runs one full shadow build and one exit reconcile a frame."""
    cfg, jdata, jpipe, params, stats, _ = setup
    cfg = _configure(cfg, integration, gather)
    jpipe = JPipeline(cfg)
    assert jpipe.row_path == (integration == "rows")
    assert jpipe.packed16_gather == (gather == "f16packed")
    jdb = JDatabase(jdata, cfg.DATA)
    pipe, db = _port(cfg, params, stats, jdata)
    assert (pipe.row_path, pipe.packed16_gather) == (
        jpipe.row_path, jpipe.packed16_gather)
    calls = {"build_shadow": 0, "volume_from_rows": 0}
    for name in calls:
        fn = getattr(rowvol, name)

        def counted(*a, name=name, fn=fn, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(rowvol, name, counted)
    for i in range(N_FRAMES):
        b = _batch(jdata[i])
        jpipe.fuse(b, jdb, params, stats)
        pipe.fuse(b, db)
    n_row = N_FRAMES if integration == "rows" else 0
    assert calls == {"build_shadow": n_row, "volume_from_rows": n_row}
    s = jdata.scenes[0]
    assert db.state[s]
    jn, jw, jk = _volumes(jdb, s)
    tn, tw, tk = _volumes(db, s)
    assert (jw > 0.05).sum() > 1000 and (jk > 0).sum() > 1000
    np.testing.assert_allclose(tw, jw, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tk, jk)


def test_scalar_fuse_sequence_matches_per_frame_fuse(setup):
    """The flat ``fuse_sequence`` over a chunk (a padded, all-masked tail
    frame too) equals the port's per-frame ``fuse`` loop bit for bit, and
    the JAX package's flat ``fuse_sequence`` within the bounds above."""
    cfg, jdata, _, params, stats, frames = setup
    cfg = _configure(cfg, "scalar")
    pipe, db = _port(cfg, params, stats, jdata)
    s = jdata.scenes[0]
    tframes = {k: torch.as_tensor(v) for k, v in frames.items()}
    tframes = {k: torch.cat([x, x[-1:]]) for k, x in tframes.items()}
    tframes["mask"][-1] = False
    seq = pipe.fuse_sequence(db.volumes[s], tframes)
    db.reset()
    for i in range(N_FRAMES):
        pipe.fuse(_batch(jdata[i]), db)
    for a, b in ((seq.num, db.volumes[s].num),
                 (seq.weights, db.volumes[s].weights),
                 (seq.semkey, db.volumes[s].semkey)):
        assert torch.equal(a, b)
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    jout = jpipe.fuse_sequence((params, stats), jdb.volumes[s],
                               {k: jnp.asarray(v.numpy())
                                for k, v in tframes.items()}, None)
    np.testing.assert_allclose(seq.weights.numpy(),
                               np.asarray(jout.weights), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(seq.num.numpy(), np.asarray(jout.num),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(seq.semkey.numpy(),
                                  np.asarray(jout.semkey))


def _spy_flat(pipe):
    """Record each flat training frame's net inputs, extraction, gt
    values and ray mask."""
    seen = []
    frontend, extract_gt = pipe._flat_frontend, pipe._extract_gt

    def spy_frontend(*a, **kw):
        out = frontend(*a, **kw)
        seen.append(list(out))
        return out

    def spy_gt(*a, **kw):
        out = extract_gt(*a, **kw)
        seen[-1].append(out)
        return out
    pipe._flat_frontend, pipe._extract_gt = spy_frontend, spy_gt
    return lambda: [(inp, vals.fusion_values, vals.fusion_weights,
                     gt.fusion_values, filtered.reshape(-1) != 0)
                    for _, filtered, vals, inp, gt in seen]


@pytest.mark.parametrize("mode", ["fuse_training", "train_sequence"])
def test_flat_training_matches_jax(setup, mode):
    """``fuse_training`` (4 per-frame calls, BatchNorm statistics carried;
    their losses and gradients summed) and the flat ``train_sequence``
    (one chunk of 4 with a reset before the third frame, the gradients
    summed): the loss within 5e-3 of JAX's and rtol 1e-5 of the float64
    reference, the gradients within 5e-3 of the reference and of JAX's within JAX's own distance from it + 5e-3, the
    estimates within 1e-4 of the reference, the statistics within 1e-5 of
    the reference and 1e-4 of JAX's, w within 1e-4
    (tests/test_train_sequence.py), the tsdf within 2e-3 of JAX's where
    the weight exceeds 0.05 (the JAX pipeline's f32 estimates lie ~1e-3
    from the reference: tests/test_torch_train_pipeline.py's bound), keys
    untouched."""
    cfg, jdata, _, params, stats, frames = setup
    cfg = _configure(cfg, "scalar")
    jpipe = JPipeline(cfg)
    jdb = JDatabase(jdata, cfg.DATA)
    pipe, db = _port(cfg, params, stats, jdata, train=True)
    inputs = _spy_flat(pipe)
    s = jdata.scenes[0]
    net = pipe.fusion_net
    ests = []
    net.register_forward_hook(lambda m, i, o: ests.append(o.detach()))
    if mode == "fuse_training":
        jstats, jl, jgrads, losses = stats, 0.0, None, 0.0
        net.zero_grad()     # the frames' gradients add up in .grad
        for i in range(N_FRAMES):
            b = _batch(jdata[i])
            loss, g, jstats = jpipe.fuse_training(b, jdb, params, jstats)
            jl += float(loss)
            jgrads = g if jgrads is None else jax.tree_util.tree_map(
                jnp.add, jgrads, g)
            losses += float(pipe.fuse_training(b, db))
        jvol, vol = jdb.volumes[s], db.volumes[s]
    else:
        jloss, jgrads, jvol, jstats = jpipe.train_sequence(
            params, stats, jdb.volumes[s], jdb.scenes_gt[s],
            {k: jnp.asarray(v) for k, v in frames.items()}, None,
            jax.random.split(jax.random.PRNGKey(0), N_FRAMES),
            jnp.asarray(RESETS))
        loss, vol = pipe.train_sequence(
            db.volumes[s], db.scenes_gt[s],
            {k: torch.as_tensor(v) for k, v in frames.items()},
            torch.as_tensor(RESETS))
        losses, jl = float(loss), float(jloss)
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    new_stats = to_flax(net)[1]

    seen = inputs()
    assert len(seen) == N_FRAMES
    ref_loss, ref_grads, ref_stats, ref_ests = _reference_f64(
        jpipe, params, stats, seen)
    assert abs(losses - jl) <= 5e-3
    assert losses == pytest.approx(ref_loss, rel=1e-5)
    for est, ref in zip(ests, ref_ests):
        np.testing.assert_allclose(
            est[..., :ref.shape[-1]].numpy().reshape(ref.shape), ref,
            atol=1e-4)
    assert _max_err(grads, ref_grads) <= 5e-3
    assert _max_err(grads, jgrads) <= _max_err(jgrads, ref_grads) + 5e-3
    assert _max_err(new_stats, ref_stats) <= 1e-5
    assert _max_err(new_stats, jstats) <= 1e-4
    assert _max_err(new_stats, stats) > 1e-3
    np.testing.assert_allclose(vol.weights.numpy(),
                               np.asarray(jvol.weights), atol=1e-4)
    obs = np.asarray(jvol.weights) > 0.05
    assert obs.sum() > 1000
    np.testing.assert_allclose(vol.tsdf.numpy()[obs],
                               np.asarray(jvol.tsdf)[obs], atol=2e-3)
    assert not vol.semkey.any()
