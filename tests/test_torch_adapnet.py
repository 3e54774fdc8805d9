"""AdapNet++ in the port against the Flax module, on the CPU: stage 1
(both input modes) and stage 2 at inference, all three heads; stage 1 in
train mode under ``jax.value_and_grad`` with the segmentation trainer's
loss (1.0 / 0.6 / 0.5 cross-entropy over ``[res, aux1, aux2]``, label 0
ignored); bf16 compute on f32 master weights against Flax's bf16; the
aux heads' upsampling against ``jax.image.resize``; per-element dropout.

Inputs are 32x32 frames, batch 2, from a seeded numpy generator; the
parameters come from ``random_variables`` and cross by
``utils/convert.py``. In train mode the f32 gradients of a random-weight
ResNet-50 at 32x32 are ill-conditioned: Flax's own f32 gradients lie
0.161 of the largest gradient from its float64 evaluation (the port's
f32: 0.128), the error growing towards the stem. So the port is held
structurally in float64 (against Flax in float64, to float32 rounding of
the compared trees) and in f32 within JAX's own f32 distance from
float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.models.adapnet import AdapNet as JAdapNet
from segfusion_tpu.models.adapnet import SegmenterAdapter as JSeg
from segfusion_tpu.utils.losses import cross_entropy as j_cross_entropy
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models.adapnet import (AdapNet, SegmenterAdapter,
                                                build_adapnet, upsample)
from segfusion_tpu_torch.models.layers import Dropout
from segfusion_tpu_torch.utils import tracing
from segfusion_tpu_torch.utils.convert import (adapnet_from_flax, flax_tree,
                                               to_flax)
from segfusion_tpu_torch.utils.losses import cross_entropy
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

B, H, W = 2, 32, 32
N_CLASSES = 4
LOSS_WEIGHTS = (1.0, 0.6, 0.5)
leaves = jax.tree_util.tree_leaves


def _frames(rng):
    images = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    depths = rng.uniform(0.3, 4.0, (B, H, W)).astype(np.float32)
    return images, depths


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("stage,mode", [(1, "tof_depth"), (1, "image"),
                                        (2, "tof_depth")])
def test_inference_heads_match_flax(stage, mode):
    """res, aux1 and aux2 of the f32 forward against Flax's, and the
    adapter's logits against the JAX adapter's: atol 2e-3 + rtol 1e-3,
    as the stage-2 test of tests/test_torch_nets.py (measured 4.8e-7)."""
    rng = np.random.RandomState(stage)
    model = JAdapNet(n_classes=8, stage=stage)
    params, stats = random_variables(model, rng,
                                     *[jnp.zeros((1, H, W, 3))] * stage)
    images, depths = _frames(rng)
    img, dep = images / 255.0, np.repeat(depths[..., None], 3, axis=-1)
    ins = ([img if mode == "image" else dep] if stage == 1
           else [img, dep])
    want = model.apply({"params": params, "batch_stats": stats},
                       *map(jnp.asarray, ins), train=False)
    net = adapnet_from_flax(params, stats, Config(
        {"n_classes": 8, "stage": stage})).eval()
    with torch.no_grad():
        got = net(*map(_nchw, ins))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (B, H, W, 8)
        assert g.dtype == np.float32
        assert np.abs(np.asarray(w)).max() > 0.2   # not degenerate
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=1e-3)

    seg = SegmenterAdapter(net, mode)
    got = seg.apply_fn_batched(torch.from_numpy(images),
                               torch.from_numpy(depths)).numpy()
    want = np.asarray(JSeg(model, mode).apply_fn_batched(
        (params, stats), jnp.asarray(images), jnp.asarray(depths)))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("factor,shape", [(8, (2, 4, 2, 4)),
                                          (4, (1, 3, 5, 3)),
                                          (4, (2, 2, 1, 1))])
def test_upsample_matches_jax_resize(factor, shape):
    """The aux heads' ``upsample`` against ``jax.image.resize(...,
    "bilinear")``, whose half-pixel centres put the first and last output
    rows outside the input's: every pixel, the edges included, within
    1e-6 (the interior is a two-tap lerp in either)."""
    x = np.random.RandomState(factor).randn(*shape).astype(np.float32)
    b, c, h, w = shape
    want = np.asarray(jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                                       (b, h * factor, w * factor, c),
                                       "bilinear")).transpose(0, 3, 1, 2)
    got = upsample(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the border rows and columns hold the edge values
    np.testing.assert_allclose(got[..., 0, 0], x[..., 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[..., -1, -1], x[..., -1, -1], atol=1e-6)


@pytest.fixture(scope="module")
def stage1_train():
    """The stage-1 problem (resn50_dropout off, random labels over 4
    classes) and Flax's (loss, grads, new batch_stats) in float64, float32
    and bfloat16."""
    rng = np.random.RandomState(0)
    model = JAdapNet(n_classes=N_CLASSES, stage=1, resn50_dropout=False)
    params, stats = random_variables(model, rng, jnp.zeros((1, H, W, 3)))
    x = rng.uniform(0.3, 4.0, (B, H, W, 3)).astype(np.float32)
    y = rng.randint(0, N_CLASSES, (B, H, W)).astype(np.int32)

    def flax_run(fmodel, f64):
        cast = ((lambda a: jnp.asarray(np.asarray(a, np.float64))) if f64
                else jnp.asarray)
        p = jax.tree_util.tree_map(cast, params)
        s = jax.tree_util.tree_map(cast, stats)

        def loss_fn(p):
            outs, mut = fmodel.apply({"params": p, "batch_stats": s},
                                     cast(x), train=True,
                                     mutable=["batch_stats"])
            return sum(lw * j_cross_entropy(o, jnp.asarray(y),
                                            ignore_index=0)
                       for lw, o in zip(LOSS_WEIGHTS, outs)), \
                mut["batch_stats"]

        (loss, new), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p)
        host = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        return float(loss), host(grads), host(new)

    with jax.enable_x64(True):
        f64 = flax_run(model, True)
    f32 = flax_run(model, False)
    bf16 = flax_run(JAdapNet(n_classes=N_CLASSES, stage=1,
                             resn50_dropout=False, dtype=jnp.bfloat16),
                    False)
    return params, stats, x, y, {"f64": f64, "f32": f32, "bf16": bf16}


def _port_train(params, stats, x, y, dtype=torch.float32,
                compute_dtype=None):
    net = adapnet_from_flax(params, stats, Config(
        {"n_classes": N_CLASSES, "stage": 1, "resn50_dropout": False}))
    net = net.to(dtype).train()
    net.compute_dtype = compute_dtype
    outs = net(_nchw(x).to(dtype))
    labels = torch.from_numpy(y).long()
    loss = sum(lw * cross_entropy(o.permute(0, 2, 3, 1), labels,
                                  ignore_index=0)
               for lw, o in zip(LOSS_WEIGHTS, outs))
    loss.backward()
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    return float(loss.detach()), grads, to_flax(net)[1]


def _max_err(a, b):
    return max(float(np.abs(np.asarray(u, np.float64)
                            - np.asarray(v, np.float64)).max())
               for u, v in zip(leaves(a), leaves(b)))


def _errors(run, ref):
    """(relative loss error, max gradient error over the largest
    gradient, max statistics error) of ``run`` against ``ref``."""
    gmax = max(float(np.abs(g).max()) for g in leaves(ref[1]))
    return (abs(run[0] - ref[0]) / abs(ref[0]),
            _max_err(run[1], ref[1]) / gmax, _max_err(run[2], ref[2]))


def test_stage1_train_mode_matches_flax(stage1_train):
    """Loss, every parameter gradient and the new running statistics of
    one train-mode step. The port in float64 against Flax in float64:
    loss rtol 1e-6, gradients within 1e-6 of the largest, statistics
    within 1e-6 (measured 7e-8, 6.7e-8, 1.1e-7: the float32 of the
    compared trees). The port in f32 against Flax in float64: within
    1.25x JAX's own f32 distance from it, as tests/test_torch_train_net.py
    holds bf16 (measured port / JAX: loss 3.1e-5 / 8.2e-5, gradients
    0.128 / 0.161 of the largest, 0.148 with the port's convolutions on
    another thread count, statistics 2.3e-4 / 4.1e-4)."""
    params, stats, x, y, flax = stage1_train
    ref = flax["f64"]
    port64 = _port_train(params, stats, x, y, torch.float64)
    assert jax.tree_util.tree_structure(port64[1]) == \
        jax.tree_util.tree_structure(ref[1])
    assert jax.tree_util.tree_structure(port64[2]) == \
        jax.tree_util.tree_structure(ref[2])
    loss_e, grad_e, stat_e = _errors(port64, ref)
    assert loss_e <= 1e-6 and grad_e <= 1e-6 and stat_e <= 1e-6, \
        (loss_e, grad_e, stat_e)
    assert _max_err(ref[2], stats) > 0.1               # the stats moved

    port32 = _errors(_port_train(params, stats, x, y), ref)
    jax32 = _errors(flax["f32"], ref)
    assert all(p <= 1.25 * j for p, j in zip(port32, jax32)), \
        (port32, jax32)


def test_stage1_bf16_train_within_flax_bf16(stage1_train):
    """bf16 compute on f32 master weights against Flax's
    ``dtype=bfloat16``, both held to the float64 reference: the port's
    loss, gradient and statistics errors each at most twice Flax bf16's
    (measured port / Flax: loss 0.0013 / 0.012, gradients 1.47 / 1.61 of
    the largest, statistics 0.57 / 0.41; with torch on another thread
    count the port's 0.016, 1.02 and 0.65 — bf16 rounds each of ~70
    convolutions' outputs, so which of the two lands nearer float64 on a
    given leaf is chance)."""
    params, stats, x, y, flax = stage1_train
    ref = flax["f64"]
    port = _errors(_port_train(params, stats, x, y,
                               compute_dtype=torch.bfloat16), ref)
    jbf = _errors(flax["bf16"], ref)
    assert all(p <= 2 * j for p, j in zip(port, jbf)), (port, jbf)


def test_master_weights_infer_like_the_cast_net():
    """A float32 AdapNet computing in bfloat16 infers bit-identically to
    the same net cast to bfloat16 (the inference pipelines' form), with
    ``build_adapnet`` setting the compute dtype from the config."""
    cfg = Config({"n_classes": 5, "stage": 1, "compute_dtype": "bfloat16"})
    torch.manual_seed(0)
    master = build_adapnet(cfg).eval()
    assert master.compute_dtype == torch.bfloat16
    cast = AdapNet(5, stage=1).eval()
    cast.load_state_dict(master.state_dict())
    cast = cast.to(torch.bfloat16)
    x = torch.rand(1, 3, 32, 32)
    with torch.no_grad():
        for a, b in zip(master(x), cast(x)):
            assert a.dtype == b.dtype == torch.float32
            assert torch.equal(a, b)
    assert master.encoder_mod1.Conv_0.weight.dtype == torch.float32


def test_per_element_dropout_rate_and_generator():
    """AdapNet's layer3[2] dropout (rate 0.5, no broadcast): each element
    kept with probability 0.5 and scaled by 2, the same seed the same
    mask, the global RNG untouched; resn50_dropout gates the layer; the
    net's dropout draws from the generator it is given."""
    drop = Dropout(0.5, per_channel=False).train()
    x = torch.rand(2, 64, 16, 16) + 1.0
    state = torch.get_rng_state()
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)
    assert torch.equal(torch.get_rng_state(), state)
    kept = y != 0
    assert 0.48 < kept.float().mean() < 0.52              # 32,768 draws
    assert not torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
    assert torch.allclose(y[kept], 2 * x[kept])

    on = AdapNet(4, stage=1, resn50_dropout=True)
    off = AdapNet(4, stage=1, resn50_dropout=False)
    assert isinstance(on.encoder_mod1.BottleneckSSMA_1.drop, Dropout)
    assert sum(isinstance(m, Dropout) for m in on.modules()) == 1
    assert not any(isinstance(m, Dropout) for m in off.modules())
    with pytest.raises(RuntimeError, match="generator"):
        on.train()(torch.rand(2, 3, 32, 32))
    outs = []
    for _ in range(2):
        on.set_dropout_generator(torch.Generator().manual_seed(5))
        outs.append(on(torch.rand(2, 3, 32, 32,
                                  generator=torch.Generator()
                                  .manual_seed(1)))[0])
    assert torch.equal(outs[0], outs[1])


# -- the adapter's CUDA graphs ------------------------------------------------

def _adapter(stage=2, compute_dtype="bfloat16", seed=0):
    """A seeded eval-mode AdapNet (4 classes) behind the adapter, its
    BatchNorm statistics drawn away from identity."""
    torch.manual_seed(seed)
    net = build_adapnet(Config({"n_classes": N_CLASSES, "stage": stage,
                                "compute_dtype": compute_dtype})).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d) or hasattr(
                    m, "running_var"):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return SegmenterAdapter(net)


def _torch_frames(seed, b=B, h=H, w=W):
    images, depths = _frames(np.random.RandomState(seed))
    images = np.resize(images, (b, h, w, 3)).astype(np.float32)
    depths = np.resize(depths, (b, h, w)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(depths)


def _model_logits(seg, images, depths):
    """``model.logits`` of the adapter's normalised inputs, NHWC."""
    img = (images / 255.0).permute(0, 3, 1, 2)
    dep = depths[:, None].expand(-1, 3, -1, -1)
    with torch.no_grad():
        return seg.model.logits(img, dep).permute(0, 2, 3, 1)


def _adapnet_counts(tr):
    return {k: v for k, v in tr.counters.items()
            if k.startswith("adapnet.")}


def test_adapter_on_the_cpu_runs_eager():
    """On CPU tensors every call runs eager, counts ``adapnet.eager``,
    keeps no graph and returns ``model.logits``' bits."""
    seg = _adapter()
    frames = [_torch_frames(s) for s in (1, 2, 1)]
    with tracing.enabled() as tr:
        got = [seg.apply_fn_batched(*f) for f in frames]
    assert _adapnet_counts(tr) == {"adapnet.eager": 3}
    assert not seg._graphs
    for f, g in zip(frames, got):
        assert g.shape == (B, H, W, N_CLASSES) and g.dtype == torch.float32
        assert torch.equal(g, _model_logits(seg, *f))
    assert not torch.equal(got[0], got[1])


_SIGNATURE_CHANGES = {
    "batch": lambda seg, i, d: (seg, i[:1], d[:1]),
    "height": lambda seg, i, d: (seg, i[:, :16], d[:, :16]),
    "width": lambda seg, i, d: (seg, i[:, :, :16], d[:, :, :16]),
    "image_dtype": lambda seg, i, d: (seg, i.double(), d),
    "depth_dtype": lambda seg, i, d: (seg, i, d.double()),
    "image_device": lambda seg, i, d: (seg, i.to("meta"), d),
    "depth_device": lambda seg, i, d: (seg, i, d.to("meta")),
    "compute_dtype": lambda seg, i, d: (
        setattr(seg.model, "compute_dtype", torch.float32) or seg, i, d),
    "input_mode": lambda seg, i, d: (
        setattr(seg, "input_mode", "image") or seg, i, d),
}


@pytest.mark.parametrize("field", sorted(_SIGNATURE_CHANGES))
def test_adapter_signature_keeps_every_field(field):
    """A graph is kept by every field its forward depends on: two calls
    that differ in one of them have different signatures, two alike the
    same one."""
    seg = _adapter()
    images, depths = _torch_frames(3)
    key = seg._signature(images, depths)
    assert seg._signature(images.clone(), depths.clone()) == key
    other = _SIGNATURE_CHANGES[field](seg, images, depths)
    assert other[0]._signature(*other[1:]) != key


@pytest.fixture
def fake_adapnet_graphs(monkeypatch):
    """The adapter takes its graph path on CPU tensors: ``_on_card`` says
    yes, and ``_capture`` returns a fake graph whose replay re-runs the
    captured callable into its static output. Yields the captures made."""
    from segfusion_tpu_torch.models import adapnet as an
    captures = []

    def capture(fn, device):
        out = fn()
        captures.append(device)
        return (lambda: out.copy_(fn())), out

    monkeypatch.setattr(an, "_on_card", lambda inputs: True)
    monkeypatch.setattr(an, "_capture", capture)
    yield captures


def test_adapter_graph_counts_and_own_results(fake_adapnet_graphs):
    """n calls at one signature, each on other frames: one eager call,
    one capture, n - 1 replays (the capturing call replays its graph);
    every result equals ``model.logits`` bit for bit after all the calls
    ran (two replays in a row each keep their own result); the spans
    nest the capture and the replays."""
    seg = _adapter()
    frames = [_torch_frames(s) for s in (4, 5, 6, 7, 8)]
    with tracing.enabled() as tr:
        got = [seg.apply_fn_batched(*f) for f in frames]
    assert len(fake_adapnet_graphs) == 1
    assert _adapnet_counts(tr) == {"adapnet.eager": 1,
                                   "adapnet.captures": 1,
                                   "adapnet.replays": 4}
    names = [s["name"] for s in tr.spans]
    assert names.count("adapnet.capture") == 1
    assert names.count("adapnet.replay") == 4
    for f, g in zip(frames, got):
        assert torch.equal(g, _model_logits(seg, *f))
    assert not torch.equal(got[3], got[4])


def test_adapter_moved_storage_drops_graphs(fake_adapnet_graphs):
    """A parameter whose storage moved drops every graph: the next call
    runs eager and the one after captures anew, reading the new value;
    an in-place change is read by the next replay without a capture."""
    seg = _adapter()
    x = _torch_frames(9)
    conv = seg.model.decoder.Conv_6
    with torch.no_grad():
        seg.apply_fn_batched(*x), seg.apply_fn_batched(*x)
        conv.weight.mul_(1.5)
        with tracing.enabled() as tr:
            inplace = seg.apply_fn_batched(*x)
        assert _adapnet_counts(tr) == {"adapnet.replays": 1}
        assert torch.equal(inplace, _model_logits(seg, *x))
        conv.weight.data = conv.weight.data * 2.0
        with tracing.enabled() as tr:
            got = [seg.apply_fn_batched(*x) for _ in range(3)]
    assert _adapnet_counts(tr) == {"adapnet.eager": 1,
                                   "adapnet.captures": 1,
                                   "adapnet.replays": 2}
    assert len(fake_adapnet_graphs) == 2
    for g in got:
        assert torch.equal(g, _model_logits(seg, *x))
    assert not torch.equal(inplace, got[-1])


def test_adapter_train_mode_and_dispatch_modes_run_eager(
        fake_adapnet_graphs):
    """With the model in train mode, or under a ``TorchDispatchMode``
    (the NaN guard), a call runs eager and captures nothing."""
    seg = _adapter()
    x = _torch_frames(10)
    seg.model.train()
    seg.model.set_dropout_generator(torch.Generator().manual_seed(2))
    with tracing.enabled() as tr:
        seg.apply_fn_batched(*x), seg.apply_fn_batched(*x)
    seg.model.eval()
    guarded = tracing.nan_guard(seg.apply_fn_batched)
    with tracing.enabled() as tr2:
        got = [guarded(*x) for _ in range(2)]
    assert _adapnet_counts(tr) == {"adapnet.eager": 2}
    assert _adapnet_counts(tr2) == {"adapnet.eager": 2}
    assert not fake_adapnet_graphs and not seg._graphs
    assert torch.equal(got[1], _model_logits(seg, *x))
