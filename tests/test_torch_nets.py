"""Port parity: FusionNet v3 and AdapNet++ stage 2 in PyTorch against the
Flax modules, with the same parameters carried across by
``segfusion_tpu_torch.utils.convert`` (f32 on the CPU).

Parameter trees come from ``jax.eval_shape`` (no Flax init compile) and
are filled with numpy from a seed; BatchNorm statistics are randomised
too, so the running-stat path is exercised.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.models.adapnet import AdapNet, SegmenterAdapter as JSeg
from segfusion_tpu.models.fusionnet import FusionNetV3 as JFusionNetV3
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models.adapnet import SegmenterAdapter
from segfusion_tpu_torch.utils.convert import (adapnet_from_flax,
                                               fusionnet_from_flax, load_flax)
from segfusion_tpu_torch.models.fusionnet import FusionNetV3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for each test (other test files import
    this fixture): the suite runs six workers on the machine's cores, where
    OpenMP's spinning threads, oversubscribed, slow the port's small-op
    loops about ninefold (``train_fusion`` on synthetic_small, on an
    8-core CPU beside five busy processes: 110 s with 8 threads, 12 s
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(module, rng, *args):
    """numpy (params, batch_stats) shaped like ``module.init(*args)``."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, train=False),
        *args)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)  # bias, mean

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled.get("batch_stats", {})


def _fusion_inputs(rng, b, h, w, n_points, use_semantics):
    data = {
        "tsdf_values": rng.randn(b, h, w, n_points).astype(np.float32) * .05,
        "tsdf_weights": rng.uniform(0, 3, (b, h, w, n_points)).astype(
            np.float32),
        "tsdf_frame": rng.uniform(0.5, 3, (b, h, w, 1)).astype(np.float32),
    }
    if use_semantics:
        data["semantic_frame"] = rng.uniform(0, 1, (b, h, w, 1)).astype(
            np.float32)
    return data


@pytest.mark.parametrize("gf,use_semantics", [(2, True), (3, True),
                                              (3, False)])
def test_fusionnet_v3_matches_flax(gf, use_semantics):
    """f32 forward, atol 2e-4 (the JAX package's bound for the torch
    reference): same convolutions, different summation order."""
    rng = np.random.RandomState(gf)
    n_points, h, w = 9, 24, 24
    fmodel = JFusionNetV3(n_points=n_points, use_semantics=use_semantics,
                          output_scale=1.0, growth_factor=gf)
    data = _fusion_inputs(rng, 2, h, w, n_points, use_semantics)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params, stats = random_variables(fmodel, rng, jdata)
    want = np.asarray(fmodel.apply({"params": params, "batch_stats": stats},
                                   jdata, train=False))

    cfg = Config({"name": "v3", "n_points": n_points,
                  "use_semantics": use_semantics, "output_scale": 1.0,
                  "growth_factor": gf})
    net = fusionnet_from_flax(params, stats, cfg).eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in data.items()}).numpy()
    assert got.shape == want.shape == (2, h, w, n_points)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_adapnet_stage2_logits_match_flax():
    """Stage-2 (RGB + depth) logits through the SegmenterAdapter on 32x32
    frames, f32: atol 2e-3 + rtol 1e-3 on logits of magnitude ~1-10 (two
    ResNet-50 encoders, ~120 convolutions summed in another order; the
    transposed convolutions check the kernel flip)."""
    rng = np.random.RandomState(0)
    b, h, w = 2, 32, 32
    model = AdapNet(n_classes=30, stage=2)
    params, stats = random_variables(model, rng, jnp.zeros((1, h, w, 3)),
                                     jnp.zeros((1, h, w, 3)))
    images = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    depths = rng.uniform(0.3, 4.0, (b, h, w)).astype(np.float32)
    want = np.asarray(JSeg(model).apply_fn_batched(
        (params, stats), jnp.asarray(images), jnp.asarray(depths)))

    net = adapnet_from_flax(params, stats, Config({"n_classes": 30,
                                                   "stage": 2})).eval()
    seg = SegmenterAdapter(net)
    got = seg.apply_fn_batched(torch.from_numpy(images),
                               torch.from_numpy(depths)).numpy()
    assert got.shape == want.shape == (b, h, w, 30)
    assert np.abs(want).max() > 0.5           # logits are not degenerate
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    # one frame alone == its slot in the batch (up to conv algorithm
    # choice for another batch size)
    np.testing.assert_allclose(
        seg.apply_fn(torch.from_numpy(images[1]),
                     torch.from_numpy(depths[1])).numpy(), got[1],
        atol=1e-5, rtol=0)


def test_load_flax_rejects_incomplete_trees():
    """Every Flax leaf consumed and every module tensor set, or raise."""
    rng = np.random.RandomState(1)
    fmodel = JFusionNetV3(n_points=5, use_semantics=False, growth_factor=2)
    data = _fusion_inputs(rng, 1, 8, 8, 5, False)
    params, stats = random_variables(
        fmodel, rng, {k: jnp.asarray(v) for k, v in data.items()})
    net = FusionNetV3(n_points=5, use_semantics=False, growth_factor=2)
    load_flax(net, params, stats)                 # complete: loads
    short_p, short_s = dict(params), dict(stats)
    short_p.pop("Pred_0")
    short_s.pop("Pred_0")
    with pytest.raises(ValueError, match="not set"):
        load_flax(FusionNetV3(n_points=5, growth_factor=2), short_p, short_s)
    extra = dict(stats)
    extra["stray"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        load_flax(FusionNetV3(n_points=5, growth_factor=2), params, extra)


def test_fusionnet_v3_bf16_no_worse_than_flax_bf16():
    """The headline's bf16 FusionNet (v3, growth factor 6, semantic head,
    32x32, the net cast to bf16 as the inference Pipeline casts it): its
    max |error| against the f32 Flax forward is at most 1.25x that of
    Flax's own bf16 forward (ROADMAP Queue 3 measured 3.32e-3 against
    3.36e-3)."""
    rng = np.random.RandomState(6)
    fmodel = JFusionNetV3(n_points=9, use_semantics=True, growth_factor=6)
    data = _fusion_inputs(rng, 1, 32, 32, 9, True)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params, stats = random_variables(fmodel, rng, jdata)
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(fmodel.apply(variables, jdata, train=False))
    flax_bf16 = np.asarray(JFusionNetV3(
        n_points=9, use_semantics=True, growth_factor=6,
        dtype=jnp.bfloat16).apply(variables, jdata, train=False), np.float32)
    cfg = Config({"name": "v3", "n_points": 9, "use_semantics": True,
                  "output_scale": 1.0, "growth_factor": 6})
    net = fusionnet_from_flax(params, stats, cfg).to(torch.bfloat16).eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in data.items()}).numpy()
    err_flax = np.abs(flax_bf16 - want).max()
    err_port = np.abs(got - want).max()
    assert 0 < err_flax < 0.05
    assert err_port <= 1.25 * err_flax, (err_port, err_flax)


def test_adapnet_stage2_bf16_argmax_agrees_with_jax_bf16():
    """The headline's bf16 AdapNet++ stage 2 (64x64, 2 frames): the
    port's per-pixel argmax agrees with the JAX package's bf16 argmax on
    at least 99% of pixels (ROADMAP Queue 3 measured 99.40%; near-ties
    flip under bf16 rounding)."""
    rng = np.random.RandomState(0)
    b, h, w = 2, 64, 64
    model = AdapNet(n_classes=30, stage=2)
    params, stats = random_variables(model, rng, jnp.zeros((1, h, w, 3)),
                                     jnp.zeros((1, h, w, 3)))
    images = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    depths = rng.uniform(0.3, 4.0, (b, h, w)).astype(np.float32)
    jmodel = AdapNet(n_classes=30, stage=2, dtype=jnp.bfloat16)
    want = np.asarray(JSeg(jmodel).apply_fn_batched(
        (params, stats), jnp.asarray(images), jnp.asarray(depths)),
        np.float32).argmax(-1)
    net = adapnet_from_flax(params, stats, Config({"n_classes": 30,
                                                   "stage": 2}))
    seg = SegmenterAdapter(net.to(torch.bfloat16).eval())
    got = seg.apply_fn_batched(torch.from_numpy(images),
                               torch.from_numpy(depths)).float().numpy()
    agree = (got.argmax(-1) == want).mean()
    assert agree >= 0.99, agree
