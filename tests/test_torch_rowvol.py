"""Port parity: slot-row layout, packing, shadow/reconcile and the row
extraction/integration ops of ``segfusion_tpu_torch`` against the JAX
package on the CPU (XLA, and the Pallas kernels in interpret mode).

Inputs are made with numpy from a seed and fed to both. Packed words are
int32 in the port and uint32 in JAX; they are compared through
``.view(np.uint32)``. Tolerances are stated per test; "bit-exact" means
``np.array_equal`` on the raw values.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.ops import geometry as jgeo
from segfusion_tpu.ops import integrate as jinteg
from segfusion_tpu.ops import rowvol as jrv
from segfusion_tpu.ops.pallas import shadow_build as jsb
from segfusion_tpu_torch.ops import geometry as tgeo
from segfusion_tpu_torch.ops import integrate as tinteg
from segfusion_tpu_torch.ops import rowvol as trv
from segfusion_tpu_torch.ops.kernels import shadow_build as tsb

SHAPES = [(64, 64, 64), (84, 84, 84)]


def _u32(a):
    """Port int32 words / JAX uint32 words -> numpy uint32."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_bits(a):
    """bf16 array of either framework -> numpy uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _geo_pair(geo_f32: np.ndarray, dtype: str):
    """The same slot state in both frameworks (bf16 rounded RTNE by each:
    identical bits)."""
    if dtype == "float32":
        return jnp.asarray(geo_f32), _t(geo_f32)
    return (jnp.asarray(geo_f32).astype(jnp.bfloat16),
            _t(geo_f32).to(torch.bfloat16))


def reachable_geo(L, rng) -> np.ndarray:
    """Random slot-geo mass in every component, restricted to states the
    writers can reach (tests/test_shadow_pallas.py): pad rows, components
    pointing outside the volume and slots beyond Z are zero."""
    g5 = (rng.randn(L.geo_rows, 128).astype(np.float32) * 0.3).reshape(
        L.X, L.SY, L.G, 8, 16)
    g5[:, 0] = 0.0
    g5[:, L.Y + 1:] = 0.0
    for c in (2, 3, 6, 7):
        g5[:, L.Y, :, c] = 0.0
    gz, sz = (L.Z - 1) // 16, (L.Z - 1) % 16
    for c in (1, 3, 5, 7):
        g5[:, :, gz, c, sz] = 0.0
    g5[:, :, gz, :, sz + 1:] = 0.0
    g5[:, :, gz + 1:] = 0.0
    return g5.reshape(L.geo_rows, 128)


# -- layout (pure Python, exact) ---------------------------------------------

@pytest.mark.parametrize("shape", [(448, 448, 448), (64, 64, 64),
                                   (84, 84, 84), (84, 88, 84),
                                   (24, 20, 160), (5, 6, 12)])
def test_layout_and_tiling_match(shape):
    jl = jrv.RowLayout.for_shape(shape)
    tl = trv.RowLayout.for_shape(shape)
    assert tuple(tl) == tuple(jl)
    assert (tl.geo_rows, tl.key_rows, tl.shadow_rows) == \
        (jl.geo_rows, jl.key_rows, jl.shadow_rows)
    assert trv.shadow_tiling(tl) == jrv.shadow_tiling(jl)
    for max_ty in (None, 4, 112):
        outcome = []
        for pick in (trv.pick_ty, jrv.pick_ty):
            try:
                outcome.append(pick(shape[1], max_ty))
            except ValueError:
                outcome.append("ValueError")
        assert outcome[0] == outcome[1]
    for n in (1, 7, 4096, 262144, 3 * 262144 + 6, 1835008):
        for target in (1, 5, 16384, 262144 * 14):
            assert trv._nchunks(n, target) == jrv._nchunks(n, target)


def test_layout_headline_values():
    """The headline volume's layout (448^3: G=28, GK=14, SY=452; TY=56,
    NJ=8) and the no-8-divisor extent 84."""
    L = trv.RowLayout.for_shape((448, 448, 448))
    assert (L.G, L.GK, L.SY) == (28, 14, 452)
    assert (L.geo_rows, L.key_rows) == (5669888, 2809856)
    assert trv.shadow_tiling(L) == (56, 8)
    assert trv.pick_ty(84) == 84
    with pytest.raises(ValueError):
        trv.pick_ty(8 * 4 * 56 + 4)


# -- packing (bit-exact) ------------------------------------------------------

def _edge_floats(rng):
    return np.concatenate([
        rng.randn(4096).astype(np.float32) * 0.1,
        rng.randn(4096).astype(np.float32) * 1000.0,
        rng.uniform(1e-9, 1e-4, 2048).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 65504.0, 1e9, -1e9, 3.4e38,
                  -3.4e38, 1e-38, -1e-38, 1e-45, -1e-45, 1.1754942e-38,
                  1.0 + 2 ** -9, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9],
                 np.float32),
    ])


def test_pack16_numw_bit_exact():
    """Including 0, -0, +-inf, subnormals and RTNE ties."""
    rng = np.random.RandomState(0)
    num = _edge_floats(rng)
    w = np.abs(num[::-1]).copy()
    want = _u32(jgeo.pack16_numw(jnp.asarray(num), jnp.asarray(w)))
    got = tgeo.pack16_numw(_t(num), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    jn, jw = jgeo.unpack16_numw(jnp.asarray(want))
    tn, tw = tgeo.unpack16_numw(got)
    np.testing.assert_array_equal(tn.numpy().view(np.uint32),
                                  np.asarray(jn).view(np.uint32))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw).view(np.uint32))


def test_pack_semantic_key_bit_exact():
    rng = np.random.RandomState(1)
    scores = np.concatenate([rng.rand(4000), [0.0, 1.0, 0.5, 1e-7]]
                            ).astype(np.float32)
    ids = rng.randint(0, 256, scores.size).astype(np.uint8)
    want = np.asarray(jinteg.pack_semantic_key(jnp.asarray(scores),
                                               jnp.asarray(ids)))
    got = tinteg.pack_semantic_key(_t(scores), _t(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    js, ji = jinteg.unpack_semantic_key(jnp.asarray(want))
    ts, ti = tinteg.unpack_semantic_key(got)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- coordinates (rtol 1e-6) --------------------------------------------------

def _camera(rng, h, w):
    f = 0.5 * w
    intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    a = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(a), np.sin(a)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pose[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return pose, intr


def test_unproject_and_ray_samples_match():
    """f32 coordinate math, different summation/inverse order: rtol 1e-6,
    plus atol 1e-6 (world points) / 1e-5 (voxel-space samples, ~50 voxels
    from the origin) for values near zero."""
    rng = np.random.RandomState(2)
    h, w = 32, 32
    pose, intr = _camera(rng, h, w)
    depth = rng.uniform(0.3, 3.0, (h, w)).astype(np.float32)
    origin = np.array([-1.6, -1.6, -1.6], np.float32)
    res = np.float32(0.05)
    jp = jgeo.unproject(jnp.asarray(depth), jnp.asarray(pose),
                        jnp.asarray(intr))
    tp = tgeo.unproject(_t(depth), _t(pose), _t(intr))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    eye = pose[:3, 3]
    jv, _ = jgeo.sample_ray_points(jp, jnp.asarray(eye), jnp.asarray(origin),
                                    res, 9)
    tv = tgeo.sample_ray_points(_t(np.asarray(jp)), _t(eye), _t(origin),
                                torch.tensor(res), 9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-5)
    # batched (written-out frame axis) == per frame
    tb = tgeo.unproject(_t(np.stack([depth, depth[::-1].copy()])),
                        _t(np.stack([pose, pose])), _t(np.stack([intr, intr])))
    np.testing.assert_array_equal(tb[0].numpy(), tp.numpy())


# -- slot state (bit-exact) ---------------------------------------------------

def _canonical(rng, shape):
    num = rng.randn(*shape).astype(np.float32)
    w = np.abs(rng.randn(*shape)).astype(np.float32) * 3
    key = rng.randint(0, 2 ** 31 - 1, shape).astype(np.int32)
    return num, w, key


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_from_volume_bit_exact(shape, dtype):
    rng = np.random.RandomState(3)
    num, w, key = _canonical(rng, shape)
    L = trv.RowLayout.for_shape(shape)
    jgeo_, jkey = jrv.rows_from_volume(
        jnp.asarray(num), jnp.asarray(w), jnp.asarray(key), L,
        geo_dtype=getattr(jnp, dtype))
    tgeo_, tkey = trv.rows_from_volume(_t(num), _t(w), _t(key), L,
                                       geo_dtype=getattr(torch, dtype))
    assert tgeo_.shape == jgeo_.shape and tkey.shape == jkey.shape
    if dtype == "float32":
        np.testing.assert_array_equal(tgeo_.numpy(), np.asarray(jgeo_))
    else:
        np.testing.assert_array_equal(_bf16_bits(tgeo_), _bf16_bits(jgeo_))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reconcile_slot_bit_exact(shape, dtype):
    """Against both the XLA reconcile and the Pallas kernel (interpret);
    random mass in every component (not only reachable states)."""
    L = trv.RowLayout.for_shape(shape)
    geo = np.random.RandomState(4).randn(L.geo_rows, 128).astype(np.float32)
    jg, tg = _geo_pair(geo, dtype)
    tn, tw = trv.volume_from_rows(tg, torch.zeros((L.key_rows, 128),
                                                  dtype=torch.int32), L)[:2]
    xn, xw = jrv._reconcile_slot(jg, L)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(xn))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(xw))
    if dtype == "bfloat16" and trv.pick_ty(L.Y) % 8:
        return      # the Pallas bf16 slab kernels need TY % 8 == 0
    pn, pw = jsb.reconcile_slot_pallas(jg, L, interpret=True)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(pn))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(pw))


@pytest.mark.parametrize("shape", SHAPES + [(6, 8, 40)])
def test_reconcile_key_bit_exact(shape):
    L = trv.RowLayout.for_shape(shape)
    key = np.random.RandomState(5).randint(
        0, 2 ** 31 - 1, (L.key_rows, 128)).astype(np.int32)
    got = tsb.reconcile_key(_t(key), L).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrv._reconcile_key(jnp.asarray(key), L)))
    np.testing.assert_array_equal(
        got, np.asarray(jsb.reconcile_key_pallas(jnp.asarray(key), L,
                                                 interpret=True)))


@pytest.mark.parametrize("shape", SHAPES + [(16, 88, 84)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_shadow_bit_exact(shape, dtype):
    """Full and dirty builds on reachable states against the XLA build and
    the Pallas kernels (interpret); the dirty build with random flags
    keeps every clean tile of a random previous shadow. (16, 88, 84) has
    the small y-tile (TY 8, 11 tiles per x) of chip_smoke.py's ragged
    (96, 88, 84)."""
    L = trv.RowLayout.for_shape(shape)
    rng = np.random.RandomState(6)
    jg, tg = _geo_pair(reachable_geo(L, rng), dtype)
    got = trv.build_shadow(tg, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _u32(got), _u32(jrv.build_shadow(jg, L, impl="xla")))

    TY, NJ = trv.shadow_tiling(L)
    prev = rng.randint(-2 ** 31, 2 ** 31 - 1,
                       (L.shadow_rows, 128)).astype(np.int32)
    dirty = np.concatenate([rng.randint(0, 2, L.X * NJ),
                            [0]]).astype(np.int32)
    tprev = _t(prev.copy())
    out = trv.build_shadow_dirty(tg, tprev, _t(dirty), L)
    assert out.data_ptr() == tprev.data_ptr()           # in place
    want = jrv.build_shadow_dirty(jg, jnp.asarray(prev.view(np.uint32)),
                                  jnp.asarray(dirty), L, impl="xla")
    np.testing.assert_array_equal(_u32(out), _u32(want))
    if dtype == "bfloat16" and TY % 8:
        return      # the Pallas bf16 slab kernels need TY % 8 == 0
    np.testing.assert_array_equal(
        _u32(got), _u32(jsb.build_shadow_pallas(jg, L, interpret=True)))
    pal = jsb.build_shadow_dirty_pallas(
        jg, jnp.asarray(prev.view(np.uint32)), jnp.asarray(dirty), L,
        interpret=True)
    np.testing.assert_array_equal(_u32(out), _u32(pal))


def test_shadow_from_canonical_bit_exact():
    rng = np.random.RandomState(7)
    shape = (12, 16, 70)
    num, w, _ = _canonical(rng, shape)
    L = trv.RowLayout.for_shape(shape)
    np.testing.assert_array_equal(
        _u32(trv.shadow_from_canonical(_t(num), _t(w), L)),
        _u32(jrv.shadow_from_canonical(jnp.asarray(num), jnp.asarray(w), L)))


# -- corner rows / mask / extraction (bit-exact given the same points) --------

def _points(rng, shape, n, p, margin=1.5):
    """Sample points spread over and slightly beyond the volume, with
    some exactly on voxel centres and boundaries."""
    hi = np.asarray(shape, np.float32)
    pts = rng.uniform(-margin, hi + margin, (n, p, 3)).astype(np.float32)
    pts[: n // 8] = np.floor(pts[: n // 8]) + 0.5
    pts[n // 8: n // 4] = np.floor(pts[n // 8: n // 4])
    return pts


@pytest.mark.parametrize("shape", SHAPES)
def test_corner_rows_bit_exact(shape):
    L = trv.RowLayout.for_shape(shape)
    pts = _points(np.random.RandomState(8), shape, 512, 9)
    jc = jrv.corner_rows(jnp.asarray(pts), L)
    tc = trv.corner_rows(_t(pts), L)
    for name in jrv.CornerRows._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)


@pytest.mark.parametrize("shape,n", [((64, 64, 64), 1024),
                                     ((84, 84, 84), 700),
                                     ((64, 64, 64), 70000)])
def test_dirty_tile_mask_bit_exact(shape, n):
    """Per-ray tiles, and (n > 65536) the coarsened ray tiles with a
    padded tail."""
    L = trv.RowLayout.for_shape(shape)
    rng = np.random.RandomState(9)
    c = rng.uniform(0, np.asarray(shape) * 0.6, 3)
    pts = (c + rng.uniform(0, 12, (n, 1, 3))
           + rng.uniform(-1, 1, (n, 7, 3))).astype(np.float32)
    np.testing.assert_array_equal(
        trv.dirty_tile_mask(_t(pts), L).numpy(),
        np.asarray(jrv.dirty_tile_mask(jnp.asarray(pts), L)))


@pytest.mark.parametrize("shape", SHAPES)
def test_extract_rows_bit_exact(shape):
    L = trv.RowLayout.for_shape(shape)
    rng = np.random.RandomState(10)
    geo = reachable_geo(L, rng)
    geo.reshape(-1)[rng.rand(geo.size) < 0.3] = 0.0   # unobserved voxels
    shadow = np.asarray(jrv.build_shadow(jnp.asarray(np.abs(geo)), L,
                                         impl="xla"))
    pts = _points(rng, shape, 600, 9)
    jfv, jfw = jrv.extract_rows(jnp.asarray(shadow),
                                jrv.corner_rows(jnp.asarray(pts), L), 0.1,
                                jgeo.INVALID_TSDF_FILL)
    tfv, tfw = trv.extract_rows(_t(shadow.view(np.int32)),
                                trv.corner_rows(_t(pts), L), 0.1,
                                tgeo.INVALID_TSDF_FILL)
    np.testing.assert_array_equal(tfv.numpy(), np.asarray(jfv))
    np.testing.assert_array_equal(tfw.numpy(), np.asarray(jfw))


# -- integration (key exact; geo within summation-order tolerance) ------------

def _integrate_inputs(rng, shape, n=400, p=9, t=7):
    num, w, key = _canonical(rng, shape)
    key = (key % (1 << 20)).astype(np.int32)
    pts = _points(rng, shape, n, p)
    values = (rng.randn(n, t) * 0.1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    ids = rng.randint(0, 30, n).astype(np.uint8)
    mask = rng.rand(n) > 0.2
    return num, w, key, pts, values, scores, ids, mask


@pytest.mark.parametrize("shape,dtype,do_sem", [
    ((64, 64, 64), "float32", None), ((64, 64, 64), "bfloat16", None),
    ((84, 84, 84), "float32", False), ((84, 84, 84), "bfloat16", None)])
def test_integrate_rows_matches(shape, dtype, do_sem):
    """Key state exact (integer max). Geo: f32 within summation-order
    tolerance (rtol 1e-5, atol 1e-5: both add the same f32 terms, in
    another order where rows repeat); bf16 within tests/test_geo_bf16.py's
    bounds (atol 0.05, rtol 0.02: RTNE per accumulation, order-
    dependent)."""
    rng = np.random.RandomState(11)
    num, w, key, pts, values, scores, ids, mask = _integrate_inputs(rng,
                                                                     shape)
    L = trv.RowLayout.for_shape(shape)
    t = values.shape[1]
    jg, jk = jrv.rows_from_volume(jnp.asarray(num), jnp.asarray(w),
                                  jnp.asarray(key), L,
                                  geo_dtype=getattr(jnp, dtype))
    jkey_in = jinteg.pack_semantic_key(jnp.asarray(scores), jnp.asarray(ids))
    jg, jk = jrv.integrate_rows(
        jg, jk, jrv.corner_rows(jnp.asarray(pts), L), jnp.asarray(values),
        jkey_in, jnp.asarray(mask), t,
        do_sem=None if do_sem is None else jnp.asarray(do_sem))
    tg, tk = trv.rows_from_volume(_t(num), _t(w), _t(key), L,
                                  geo_dtype=getattr(torch, dtype))
    tg, tk = trv.integrate_rows(
        tg, tk, trv.corner_rows(_t(pts), L), _t(values),
        tinteg.pack_semantic_key(_t(scores), _t(ids)), _t(mask), t,
        do_sem=do_sem)
    assert tg.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=0.02, atol=0.05))
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)), **tol)
    # the writer invariant holds: the reconciled key/geo state agrees too
    jn, jw, jkk = jrv.volume_from_rows(jg, jk, L, impl="xla")
    tn, tw, tkk = trv.volume_from_rows(tg, tk, L)
    np.testing.assert_array_equal(tkk.numpy(), np.asarray(jkk))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tol)


@pytest.mark.parametrize("case", ["tiling", "geo", "out"])
def test_shadow_launch_refuses_what_the_kernel_cannot_take(case):
    """The shadow-build launcher checks the y-tiling and the 16-byte
    alignment its copies and stores need before it loads the library."""
    L = trv.RowLayout.for_shape((8, 16, 40))
    geo = torch.zeros((L.geo_rows, 128))
    out = torch.zeros((L.shadow_rows, 128), dtype=torch.int32)
    ty = 16
    if case == "tiling":
        ty = 6
    elif case == "geo":
        geo = torch.zeros(L.geo_rows * 128 + 1)[1:].view(L.geo_rows, 128)
    else:
        out = torch.zeros(L.shadow_rows * 128 + 1,
                          dtype=torch.int32)[1:].view(L.shadow_rows, 128)
    with pytest.raises(ValueError, match="tiling" if case == "tiling"
                       else "16-byte aligned"):
        tsb._launch_shadow(geo, out, None, L, ty)


def test_kernel_wrappers_take_plain_version_on_cpu_only():
    """A CPU tensor takes the plain version (no launch counted); other
    devices are refused rather than silently computed elsewhere."""
    L = trv.RowLayout.for_shape((8, 16, 40))
    tsb.reset_launch_counts()
    geo = torch.zeros((L.geo_rows, 128))
    assert int(trv.build_shadow(geo, L).abs().sum()) == 0
    assert all(v == 0 for v in tsb.launch_counts().values())
    with pytest.raises(ValueError):
        tsb.build_shadow(geo.to("meta"), L, 16)
