"""Port parity for the flat integration of ``segfusion_tpu/ops/integrate.py``
against ``segfusion_tpu_torch/ops/integrate.py``, on the CPU at 44x48x44
with 900 rays of 7 samples (duplicate corners within and across rays).

Both packages scatter-add in update order on the CPU (XLA's scatter and
``index_add_``), so num and w come out equal: they are held to atol 1e-6
+ rtol 1e-6 (measured: 0.0). Semantic keys, ids and scores are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.ops import geometry as jg
from segfusion_tpu.ops import integrate as ji
from segfusion_tpu_torch.ops import geometry as tg
from segfusion_tpu_torch.ops import integrate as ti
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

SHAPE = (44, 48, 44)
TOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed=0, n=900, p=7):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-2, 50, (n, p, 3)).astype(np.float32)
    pts[n // 2:] = pts[: n - n // 2] + rng.uniform(
        -0.3, 0.3, (n - n // 2, p, 3)).astype(np.float32)   # duplicates
    values = rng.uniform(-0.1, 0.1, (n, p)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    ids = rng.randint(0, 30, n).astype(np.uint8)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::7] = scores[1::7][: len(scores[::7])]          # score ties
    w = rng.uniform(0, 3, SHAPE).astype(np.float32)
    num = (rng.uniform(-0.1, 0.1, SHAPE) * w).astype(np.float32)
    sem = rng.randint(0, 30, SHAPE).astype(np.uint8)
    sc = rng.uniform(0, 0.5, SHAPE).astype(np.float32)
    return pts, values, mask, ids, scores, w, num, sem, sc


def _t(x):
    return torch.as_tensor(np.array(x))       # a copy: the port updates in place


@pytest.mark.parametrize("use_mask", [False, True])
def test_integrate_tsdf_and_semantics_match_jax(use_mask):
    pts, values, mask, ids, scores, w, num, sem, sc = _case()
    tsdf = np.where(w > 0, num / np.maximum(w, 1e-12), 0.1).astype(np.float32)
    jidx, jwts = jg.interpolation_weights(jnp.asarray(pts))
    tidx, twts = tg.interpolation_weights(_t(pts))
    m = mask if use_mask else None
    jv, jw = ji.integrate_tsdf(jnp.asarray(tsdf), jnp.asarray(w),
                               jnp.asarray(values), jidx, jwts,
                               None if m is None else jnp.asarray(m))
    tv, tw = ti.integrate_tsdf(_t(tsdf), _t(w), _t(values), tidx, twts,
                               None if m is None else _t(m))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert (tw.numpy() > w).sum() > 1000
    jids, jsc = ji.integrate_semantics(
        jnp.asarray(sem), jnp.asarray(sc), jnp.asarray(ids),
        jnp.asarray(scores), jidx, None if m is None else jnp.asarray(m))
    tids, tsc = ti.integrate_semantics(_t(sem), _t(sc), _t(ids), _t(scores),
                                       tidx, None if m is None else _t(m))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert (tids.numpy() != sem).sum() > 100


def test_integrate_frame_matches_jax():
    """The jitted, donated JAX step against the port's; per-sample ids."""
    pts, values, mask, ids, scores, w, num, sem, sc = _case(1)
    tsdf = np.where(w > 0, num / np.maximum(w, 1e-12), 0.1).astype(np.float32)
    ids2 = np.repeat(ids[:, None], pts.shape[1], 1)
    sc2 = np.repeat(scores[:, None], pts.shape[1], 1)
    jidx, jwts = jg.interpolation_weights(jnp.asarray(pts))
    tidx, twts = tg.interpolation_weights(_t(pts))
    jr = ji.integrate_frame(jnp.asarray(tsdf), jnp.asarray(w),
                            jnp.asarray(sem), jnp.asarray(sc),
                            jnp.asarray(values), jidx, jwts,
                            jnp.asarray(mask), jnp.asarray(ids2),
                            jnp.asarray(sc2), update_semantics=True)
    tr = ti.integrate_frame(_t(tsdf), _t(w), _t(sem), _t(sc), _t(values),
                            tidx, twts, _t(mask), _t(ids2), _t(sc2),
                            update_semantics=True)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(jr.weights),
                               **TOL)
    np.testing.assert_allclose(tr.tsdf.numpy(), np.asarray(jr.tsdf), **TOL)
    np.testing.assert_array_equal(tr.semantics.numpy(),
                                  np.asarray(jr.semantics))
    np.testing.assert_array_equal(tr.scores.numpy(), np.asarray(jr.scores))
    off = ti.integrate_frame(_t(tsdf), _t(w), _t(sem), _t(sc), _t(values),
                             tidx, twts, _t(mask))
    assert off.semantics is not None and off.scores is not None
    np.testing.assert_array_equal(off.semantics.numpy(), sem)


@pytest.mark.parametrize("form", ["indices", "lin"])
def test_accumulator_forms_match_jax(form):
    """integrate_numw / integrate_semkey and their ``_lin`` forms (the
    factored extraction's indices), in place on the port's side."""
    pts, values, mask, ids, scores, w, num, sem, _ = _case(2)
    key = ji.pack_semantic_key(jnp.asarray(np.random.RandomState(3).uniform(
        0, 0.5, SHAPE).astype(np.float32)), jnp.asarray(sem))
    key = np.asarray(key)
    tn, tw, tk = _t(num), _t(w), _t(key)
    if form == "indices":
        jidx, jwts = jg.interpolation_weights(jnp.asarray(pts))
        tidx, twts = tg.interpolation_weights(_t(pts))
        jn, jw = ji.integrate_numw(jnp.asarray(num), jnp.asarray(w),
                                   jnp.asarray(values), jidx, jwts,
                                   jnp.asarray(mask))
        rn, rw = ti.integrate_numw(tn, tw, _t(values), tidx, twts, _t(mask))
        jk = ji.integrate_semkey(jnp.asarray(key), jnp.asarray(ids),
                                 jnp.asarray(scores), jidx,
                                 jnp.asarray(mask))
        rk = ti.integrate_semkey(tk, _t(ids), _t(scores), tidx, _t(mask))
    else:
        jl, jv, jwts = jg.interpolation_corners_factored(jnp.asarray(pts),
                                                         SHAPE)
        tl, tv, twts = tg.interpolation_corners_factored(_t(pts), SHAPE)
        jn, jw = ji.integrate_numw_lin(jnp.asarray(num), jnp.asarray(w),
                                       jnp.asarray(values), jl, jv, jwts,
                                       jnp.asarray(mask))
        rn, rw = ti.integrate_numw_lin(tn, tw, _t(values), tl, tv, twts,
                                       _t(mask))
        jk = ji.integrate_semkey_lin(jnp.asarray(key), jnp.asarray(ids),
                                     jnp.asarray(scores), jl, jv,
                                     jnp.asarray(mask))
        rk = ti.integrate_semkey_lin(tk, _t(ids), _t(scores), tl, tv,
                                     _t(mask))
    assert rn is tn and rw is tw and rk is tk            # in place
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tk.numpy() != key).sum() > 1000
