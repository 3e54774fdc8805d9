"""Port parity of the folded FusionNet v3 executor
(``segfusion_tpu_torch/models/fusionnet_fast.py``) against the JAX
package's ``models/fusionnet_fast.py``, and the port's ``Pipeline``
reading the four settings that switch it on (``fused_net``,
``fused_net_train``, ``fused_conv3x3``, ``fused_vortex``) as the JAX
``Pipeline`` does.

Weights are seeded numpy trees (``tests/test_torch_nets.random_variables``,
BatchNorm statistics randomised so the fold is exercised), carried onto
the port's module by ``utils/convert.py``. The JAX executor runs eagerly
on the CPU, as its own tests run it.
"""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.config import Config as JConfig, _DEFAULTS, _merge_defaults
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.models import fusionnet_fast as jff
from segfusion_tpu.models.fusionnet import FusionNetV3 as JFusionNetV3
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.models import fusionnet_fast as ff
from segfusion_tpu_torch.utils import tracing
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax
from tests.test_torch_nets import (_fusion_inputs,  # noqa: F401
                                   one_torch_thread, random_variables)

H = W = 32
N_POINTS = 9


def _net_setup(gf, use_semantics, seed, b=1):
    """(Flax module, numpy inputs, params, stats, port FUSION_MODEL)."""
    rng = np.random.RandomState(seed)
    fmodel = JFusionNetV3(n_points=N_POINTS, use_semantics=use_semantics,
                          output_scale=1.0, growth_factor=gf)
    data = _fusion_inputs(rng, b, H, W, N_POINTS, use_semantics)
    params, stats = random_variables(
        fmodel, rng, {k: jnp.asarray(v) for k, v in data.items()})
    fm = Config({"name": "v3", "n_points": N_POINTS,
                 "use_semantics": use_semantics, "output_scale": 1.0,
                 "growth_factor": gf})
    return fmodel, data, params, stats, fm


def _pipeline_config(gf, compute_dtype="bfloat16", **settings):
    """A JAX-package config (defaults merged) with FusionNet v3 and the
    semantic head at ``compute_dtype``; the port reads a copy."""
    cfg = _merge_defaults(JConfig({}), _DEFAULTS)
    cfg.DATA.resx, cfg.DATA.resy = W, H
    cfg.DATA.semantics = "class8"
    cfg.FUSION_MODEL.update(name="v3", n_points=N_POINTS, n_tail_points=7,
                            growth_factor=gf, use_semantics=True,
                            compute_dtype=compute_dtype)
    cfg.SEMANTIC_2D_MODEL.n_classes = 8
    cfg.SETTINGS.update(settings)
    return cfg


def _torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def test_port_bf16_net_matches_the_jax_default():
    """The headline's bf16 v3 (gf 6, semantic head, 32x32): the JAX
    Pipeline runs the folded executor by default on it
    (``apply_v3(fold_v3(...), dtype=bf16)``), the port's parent ran the
    eager module cast to bf16. The port's Pipeline net estimate under the
    same config now lies closer to the JAX output than that eager module
    (max and mean |d|), and its own distance from the f32 Flax forward is
    at most 1.1x the JAX executor's (measured: 9.5e-4 against 1.11e-3;
    the eager module 1.56e-3; from the JAX output the port 1.28e-3, the
    eager module 1.89e-3)."""
    fmodel, data, params, stats, fm = _net_setup(6, True, seed=6)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    ref = np.asarray(fmodel.apply({"params": params, "batch_stats": stats},
                                  jdata, train=False)).reshape(1, -1,
                                                                N_POINTS)
    jax_default = np.asarray(jff.apply_v3(
        jff.fold_v3(params, stats, growth_factor=6, use_semantics=True,
                    n_points=N_POINTS), jdata, dtype=jnp.bfloat16))

    pipe = Pipeline(Config(_pipeline_config(6)), device="cpu",
                    fusion_net=fusionnet_from_flax(params, stats, fm))
    with torch.no_grad():
        port = pipe._network_estimate(_torch(data)).numpy()
        eager = fusionnet_from_flax(params, stats, fm).to(
            torch.bfloat16).eval()(_torch(data)).numpy().reshape(
                1, -1, N_POINTS)
    assert port.shape == jax_default.shape == (1, H * W, N_POINTS)
    d_port, d_eager = np.abs(port - jax_default), np.abs(eager - jax_default)
    assert d_port.max() < d_eager.max(), (d_port.max(), d_eager.max())
    assert d_port.mean() < d_eager.mean(), (d_port.mean(), d_eager.mean())
    err_port = np.abs(port - ref).max()
    err_jax = np.abs(jax_default - ref).max()
    assert 0 < err_jax < 0.05
    assert err_port <= 1.1 * err_jax, (err_port, err_jax)


@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("mode", ["dots9", "im2col"])
@pytest.mark.parametrize("use_semantics", [True, False],
                         ids=["sem", "nosem"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_apply_matches_jax(dtype, use_semantics, mode, pack):
    """``fold_v3`` + ``apply_v3`` against JAX's at every ``fused_conv3x3``
    x ``fused_vortex`` (gf 3, 32x32, 2 frames, each frame through the
    JAX executor as its Pipeline maps it over a block). f32 within rtol
    2e-4 / atol 2e-5 (tests/test_fastnet.py's bound against Flax). bf16:
    two bf16 roundings of the same function, whose one-ulp flips
    propagate; max |d| at most 8e-3 and mean |d| at most 1e-3 (measured
    at most 5.1e-3 / 5.7e-4 over the eight cases)."""
    _, data, params, stats, fm = _net_setup(3, use_semantics, seed=3, b=2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    folded = jff.fold_v3(params, stats, growth_factor=3,
                         use_semantics=use_semantics, n_points=N_POINTS,
                         pack_vortex=pack)
    want = np.concatenate([np.asarray(jff.apply_v3(
        folded, {k: jnp.asarray(v[i:i + 1]) for k, v in data.items()},
        dtype=jdt, conv3x3=mode)) for i in range(2)])
    net = fusionnet_from_flax(params, stats, fm).eval()
    with torch.no_grad():
        got = ff.apply_v3(ff.fold_v3(net, pack), _torch(data),
                          dtype=getattr(torch, dtype), conv3x3=mode).numpy()
    assert got.shape == want.shape == (2, H * W, N_POINTS)
    assert got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        d = np.abs(got - want)
        assert d.max() <= 8e-3 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_vortex_mean_is_per_frame():
    """A batch of two different frames equals two one-frame calls: each
    vortex's image-level branch averages its own frame (f32, FastV3)."""
    _, data, params, stats, fm = _net_setup(2, True, seed=4, b=2)
    data["tsdf_frame"][1] += 2.0            # frames with other means
    fast = ff.FastV3(fusionnet_from_flax(params, stats, fm).eval(),
                     dtype=torch.float32)
    with torch.no_grad():
        both = fast(_torch(data))
        one = torch.cat([fast({k: v[i:i + 1] for k, v in
                               _torch(data).items()}) for i in range(2)])
    assert (both[0] - both[1]).abs().max() > 1e-2
    torch.testing.assert_close(both, one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("compute_dtype,settings", [
    ("bfloat16", {}),
    ("float32", {}),
    ("bfloat16", {"fused_net": "off"}),
    ("float32", {"fused_net": "on", "fused_conv3x3": "im2col",
                 "fused_vortex": "packed"}),
    ("bfloat16", {"fused_net_train": "off"}),
    ("float32", {"fused_net_train": "on"}),
    ("bfloat16", {"fused_net": "off", "fused_net_train": "on"}),
])
def test_settings_read_as_jax(compute_dtype, settings):
    """The port reads fused_net / fused_net_train / fused_conv3x3 /
    fused_vortex with the JAX Pipeline's conditions and defaults."""
    cfg = _pipeline_config(2, compute_dtype, **settings)
    jpipe = JPipeline(cfg)
    pipe = Pipeline(Config(cfg), device="cpu")
    assert pipe.fused_net == jpipe.fused_net
    assert pipe.fused_net_train == jpipe.fused_net_train
    assert pipe.fused_conv3x3 == jpipe.fused_conv3x3
    assert pipe.fused_pack_vortex == jpipe.fused_pack_vortex


def test_stacked_heads_keep_the_eager_net():
    """stack_heads v3 never takes the executor (the JAX condition)."""
    cfg = _pipeline_config(2)
    cfg.FUSION_MODEL.stack_heads = True
    pipe = Pipeline(Config(cfg), device="cpu")
    assert not pipe.fused_net and not pipe.fused_net_train
    assert not JPipeline(cfg).fused_net


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_fused_net_off_is_the_eager_module(compute_dtype):
    """``fused_net: off`` (and f32's default) infers exactly as the
    parent did: the module cast to the compute dtype, its NHWC output
    reshaped to (B, h*w, n_points)."""
    _, data, params, stats, fm = _net_setup(2, True, seed=5)
    cfg = _pipeline_config(2, compute_dtype, fused_net="off")
    pipe = Pipeline(Config(cfg), device="cpu",
                    fusion_net=fusionnet_from_flax(params, stats, fm))
    dt = getattr(torch, compute_dtype)
    assert pipe.fusion_net.Pred_0.Conv_0.weight.dtype == dt
    with torch.no_grad():
        got = pipe._network_estimate(_torch(data))
        want = fusionnet_from_flax(params, stats, fm).to(dt).eval()(
            _torch(data)).reshape(1, H * W, -1)[..., :N_POINTS]
    assert torch.equal(got, want)


# -- FastV3's CUDA graphs, on the CPU through a fake capture ------------------

@pytest.fixture
def fake_graphs(monkeypatch):
    """``FastV3`` takes its graph path on CPU tensors: ``_on_card`` says
    yes, and ``_capture`` returns a fake graph whose replay re-runs the
    captured callable into its static output. Yields the captures made."""
    captures = []

    def capture(fn, device):
        out = fn()
        captures.append(device)
        return (lambda: out.copy_(fn())), out

    monkeypatch.setattr(ff, "_on_card", lambda inputs: True)
    monkeypatch.setattr(ff, "_capture", capture)
    yield captures


def _graph_setup(use_semantics=False, b=2, seed=7):
    """(FastV3 in bf16, its folded weights, torch inputs) at gf 2."""
    _, data, params, stats, fm = _net_setup(2, use_semantics, seed, b=b)
    net = fusionnet_from_flax(params, stats, fm).eval()
    return ff.FastV3(net), ff.fold_v3(net), _torch(data)


def _graph_counts(tr):
    """The executor's counters of tracer ``tr``."""
    return {k: v for k, v in tr.counters.items()
            if k.startswith("fusionnet.")}


def _eager(folded, inputs):
    with torch.no_grad():
        return ff.apply_v3(folded, inputs)


def _frame(inputs, i, shift=0.0):
    """Frame ``i`` of ``inputs`` as a batch of one, its values moved by
    ``shift``."""
    return {k: v[i:i + 1] + shift for k, v in inputs.items()}


@pytest.mark.parametrize("use_semantics", [True, False],
                         ids=["sem", "nosem"])
def test_graph_replays_equal_apply_v3(fake_graphs, use_semantics):
    """Calls at one signature with other inputs each: the first runs
    eager, the second captures and replays, the rest replay; every
    result equals ``apply_v3`` bit for bit after all calls ran (a stale
    static input or an output the next replay overwrites would differ),
    and the counters count one eager call, one capture, three replays."""
    fast, folded, data = _graph_setup(use_semantics)
    frames = [_frame(data, 0), _frame(data, 1), _frame(data, 0, 0.25),
              _frame(data, 1, -0.5)]
    with tracing.enabled() as tr, torch.no_grad():
        got = [fast(x) for x in frames]
    assert len(fake_graphs) == 1
    assert _graph_counts(tr) == {"fusionnet.eager": 1, "fusionnet.captures": 1,
                           "fusionnet.replays": 3}
    names = [s["name"] for s in tr.spans]
    assert names.count("fusionnet.capture") == 1
    assert names.count("fusionnet.replay") == 3
    for x, y in zip(frames, got):
        assert torch.equal(y, _eager(folded, x))
    assert not torch.equal(got[0], got[2])


def test_graph_per_signature_least_recent_dropped(fake_graphs):
    """A new shape captures a graph of its own; past ``_GRAPHS_MAX``
    signatures the least recently used is dropped with its graph, and
    meeting it again runs eager before it captures anew."""
    fast, folded, data = _graph_setup()
    shapes = [{k: v[:b, :h] for k, v in data.items()}
              for b, h in ((1, 32), (2, 32), (1, 16), (2, 16), (1, 8))]
    with torch.no_grad():
        for x in shapes[:2]:
            fast(x), fast(x)
        assert len(fake_graphs) == 2
        for x in shapes[2:4]:
            fast(x), fast(x)
        assert len(fast._graphs) == ff._GRAPHS_MAX == 4
        fast(shapes[4])                       # seen once: drops shapes[0]
        assert len(fast._graphs) == 4 and len(fake_graphs) == 4
        with tracing.enabled() as tr:
            got = fast(shapes[0])
            assert _graph_counts(tr) == {"fusionnet.eager": 1}
            got = fast(shapes[0])
            assert _graph_counts(tr)["fusionnet.captures"] == 1
    assert len(fake_graphs) == 5 and len(fast._graphs) == 4
    assert torch.equal(got, _eager(folded, shapes[0]))


def test_moved_buffers_drop_every_graph(fake_graphs):
    """A buffer replaced by a copy at another address: no graph that
    read the old one replays; the next call runs eager."""
    fast, folded, data = _graph_setup()
    x = _frame(data, 0)
    with torch.no_grad():
        fast(x), fast(x)
        fast.w0 = fast.w0.clone()
        with tracing.enabled() as tr:
            got = fast(x)
    assert _graph_counts(tr) == {"fusionnet.eager": 1}
    assert list(fast._graphs.values()) == [ff._SEEN]
    assert torch.equal(got, _eager(folded, x))


def test_refold_starts_without_graphs(fake_graphs):
    """``prepare_params`` after an in-place parameter change returns a
    new executor with no graphs, whose replays give the new fold's
    numbers."""
    _, data, params, stats, fm = _net_setup(2, True, seed=8)
    pipe = Pipeline(Config(_pipeline_config(2)), device="cpu",
                    fusion_net=fusionnet_from_flax(params, stats, fm))
    x = _torch(data)
    with torch.no_grad():
        pipe._network_estimate(x), pipe._network_estimate(x)
        fast = pipe.prepare_params()
        assert len(fake_graphs) == 1 and len(fast._graphs) == 1
        pipe.fusion_net.Pred_0.Conv_0.weight.add_(0.5)
        refold = pipe.prepare_params()
        assert refold is not fast and not refold._graphs
        got = [pipe._network_estimate(x) for _ in range(3)]
    assert len(fake_graphs) == 2
    want = _eager(ff.fold_v3(pipe.fusion_net), x)[..., :N_POINTS]
    for y in got:
        assert torch.equal(y, want)
    assert not torch.equal(got[0], fast(x)[..., :N_POINTS])


@pytest.mark.parametrize("case", ["grad", "flop_counter", "nan_guard",
                                  "cpu"])
def test_graph_not_taken(fake_graphs, monkeypatch, case):
    """Gradients on, an active dispatch mode (``FlopCounterMode``,
    ``tracing.nan_guard``) or CPU tensors: every call runs eager and
    counts as such; nothing is captured."""
    from torch.utils.flop_counter import FlopCounterMode
    fast, folded, data = _graph_setup()
    x = _frame(data, 0)
    call = fast
    ctx = torch.no_grad()
    if case == "grad":
        ctx = torch.enable_grad()
    elif case == "flop_counter":
        ctx = FlopCounterMode(display=False)
    elif case == "nan_guard":
        call = tracing.nan_guard(fast)
    else:
        monkeypatch.undo()
    with tracing.enabled() as tr, ctx:
        got = [call(x) for _ in range(3)]
    assert fake_graphs == [] and not fast._graphs
    assert _graph_counts(tr) == {"fusionnet.eager": 3}
    for y in got:
        assert torch.equal(y, _eager(folded, x))


def test_count_off_records_nothing():
    """Off, a count is the one check of the module global: no tracer is
    made, no builtin called; on, counters start at the first count."""
    calls = []

    def watch(frame, event, arg):
        if event == "c_call" and frame.f_code.co_filename == tracing.__file__:
            calls.append(arg)
    sys.setprofile(watch)
    try:
        tracing.count("fusionnet.replays")
    finally:
        sys.setprofile(None)
    assert calls == [] and tracing._TRACER is None
    with tracing.enabled() as tr:
        tracing.count("fusionnet.replays")
        tracing.count("fusionnet.replays")
    assert tr.counters == {"frames": 0, "blocks": 0, "chunks": 0,
                           "fusionnet.replays": 2}
