"""Port parity for FusionNet v1 and v2 (``segfusion_tpu/models/fusionnet.py``
``FusionNetV1`` / ``FusionNetV2``) and for v3 with ``stack_heads``, the
port against the Flax modules with the parameters carried across by
``utils/convert.py``, on the CPU at 24x24 and 32x32.

v1 and v2 take no ``dropout`` and drop at 0.2, as do v3's stacked heads.
The train-mode parity runs replace Flax's ``nn.Dropout`` by the identity
for the test and set the port's dropout rates to 0 (the JAX and torch
random streams differ). Train mode is held in float64 on both sides: at
batch 1 Flax's one-pass variance ``mean(x^2) - mean^2``, which the port
keeps, cancels in float32 (the port's f32 gradients of v1 lie 1.2% of
the largest from f64, a BatchNorm bias after the first convolution;
``tests/test_torch_train_net.py`` has the same finding for v3).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.models import fusionnet as jfusionnet
from segfusion_tpu.utils.checkpoints import save_checkpoint
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models.fusionnet import (Dropout, FusionNetV1,
                                                  FusionNetV2, FusionNetV3,
                                                  build_fusion_net)
from segfusion_tpu_torch.utils.convert import (flax_tree, from_flax_tree,
                                               fusionnet_from_checkpoint,
                                               fusionnet_from_flax, load_flax,
                                               to_flax)
from segfusion_tpu_torch.utils.optim import get_optimizer
from tests.test_torch_nets import (_fusion_inputs,  # noqa: F401
                                   one_torch_thread, random_variables)
from tests.test_torch_train_net import _flax_f64, _max_err

leaves = jax.tree_util.tree_leaves
N_POINTS = 9


class _NoDropout(flax_nn.Module):
    """Flax's ``nn.Dropout`` signature, computing the identity."""
    rate: float
    broadcast_dims: tuple = ()
    deterministic: bool = None

    def __call__(self, x):
        return x


def _flax_model(name, use_semantics, gf=3, **kw):
    if name == "v1":
        return jfusionnet.FusionNetV1(n_points=N_POINTS,
                                      use_semantics=use_semantics, **kw)
    if name == "v2":
        return jfusionnet.FusionNetV2(n_points=N_POINTS,
                                      use_semantics=use_semantics,
                                      growth_factor=gf, **kw)
    return jfusionnet.FusionNetV3(n_points=N_POINTS,
                                  use_semantics=use_semantics,
                                  growth_factor=gf, stack_heads=True, **kw)


def _config(name, use_semantics, gf=3):
    return Config({"name": name, "n_points": N_POINTS,
                   "use_semantics": use_semantics, "output_scale": 1.0,
                   "growth_factor": gf, "stack_heads": name == "v3s"})


def _setup(name, use_semantics, h, w, seed=0, b=1):
    rng = np.random.RandomState(seed)
    fmodel = _flax_model(name, use_semantics)
    data = _fusion_inputs(rng, b, h, w, N_POINTS, use_semantics)
    params, stats = random_variables(
        fmodel, rng, {k: jnp.asarray(v) for k, v in data.items()})
    cfg = _config("v3" if name == "v3s" else name, use_semantics)
    cfg.stack_heads = name == "v3s"
    return fmodel, data, params, stats, cfg, rng


def _eval(fmodel, params, stats, data):
    return np.asarray(fmodel.apply({"params": params, "batch_stats": stats},
                                   {k: jnp.asarray(v) for k, v in
                                    data.items()}, train=False))


CASES = [("v1", False), ("v1", True), ("v2", False), ("v2", True),
         ("v3s", True)]


@pytest.mark.parametrize("name,use_semantics", CASES)
def test_eval_matches_flax(name, use_semantics):
    """f32 forward of 2 frames at 24x24 within atol 1e-5 (the same
    convolutions summed in another order; measured <= 6.1e-7); the net
    writes back the Flax trees it loaded, exactly."""
    fmodel, data, params, stats, cfg, _ = _setup(name, use_semantics, 24,
                                                 24, b=2)
    want = _eval(fmodel, params, stats, data)
    net = fusionnet_from_flax(params, stats, cfg).eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in data.items()}).numpy()
    assert got.shape == want.shape == (2, 24, 24, N_POINTS)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for a, b in zip(to_flax(net), (params, stats)):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        for x, y in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(x, np.asarray(y))


def _port_train_f64(params, stats, cfg, data, weight):
    net = fusionnet_from_flax(params, stats, cfg).double().train()
    for m in net.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    out = net({k: torch.from_numpy(v).double() for k, v in data.items()})
    loss = (out.double() * torch.from_numpy(weight).double()).sum()
    loss.backward()
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    return float(loss.detach()), out.detach().numpy(), grads, to_flax(net)[1]


@pytest.mark.parametrize("name,use_semantics",
                         [("v1", True), ("v2", False), ("v3s", True)])
def test_train_mode_matches_flax(name, use_semantics, monkeypatch):
    """One frame at 32x32 in train mode, dropout off, the port in f64
    against Flax in f64 (both cast the final tanh to f32): output within
    atol 1e-6, loss within rtol 1e-9, every gradient within 1e-6 of the
    largest gradient magnitude and the new running statistics within
    1e-6 (measured: 0.0, 4e-14 absolute, 4.1e-8, 6.0e-8), in Flax's tree
    layout (the stacked heads' too)."""
    monkeypatch.setattr(flax_nn, "Dropout", _NoDropout)
    fmodel, data, params, stats, cfg, rng = _setup(name, use_semantics, 32,
                                                   32, seed=1)
    weight = rng.randn(1, 32, 32, N_POINTS).astype(np.float32)
    ref_loss, ref_out, ref_grads, ref_stats = _flax_f64(fmodel, data,
                                                        params, stats,
                                                        weight)
    loss, out, grads, new_stats = _port_train_f64(params, stats, cfg, data,
                                                  weight)
    np.testing.assert_allclose(out, ref_out, atol=1e-6)
    assert loss == pytest.approx(ref_loss, rel=1e-9)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(ref_grads)
    gmax = max(float(np.abs(g).max()) for g in leaves(ref_grads))
    assert _max_err(grads, ref_grads) <= 1e-6 * gmax
    assert jax.tree_util.tree_structure(new_stats) == \
        jax.tree_util.tree_structure(ref_stats)
    assert _max_err(new_stats, ref_stats) <= 1e-6
    assert _max_err(new_stats, stats) > 1e-3      # the statistics moved


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_bf16_no_worse_than_flax_bf16(name):
    """The net cast to bf16 (as the inference Pipeline casts it): its max
    |error| against the f32 Flax forward at most 1.25x that of Flax's
    own bf16 forward (test_torch_nets' bound for v3)."""
    fmodel, data, params, stats, cfg, _ = _setup(name, True, 32, 32, seed=6)
    want = _eval(fmodel, params, stats, data)
    flax_bf16 = np.asarray(_eval(_flax_model(name, True, dtype=jnp.bfloat16),
                                 params, stats, data), np.float32)
    net = fusionnet_from_flax(params, stats, cfg).to(torch.bfloat16).eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in data.items()}).numpy()
    err_flax = np.abs(flax_bf16 - want).max()
    err_port = np.abs(got - want).max()
    assert 0 < err_flax < 0.05
    assert err_port <= 1.25 * err_flax, (err_port, err_flax)


def test_stack_heads_checkpoint_loads_and_round_trips(tmp_path):
    """A JAX FusionNetV3(stack_heads=True, use_semantics=True) checkpoint
    (its ``DualHead_0`` tree, leaves led by a head axis of 2) loads into
    the port through ``fusionnet_from_checkpoint`` and infers as Flax
    does (atol 1e-5); the port writes it back as the same stacked trees,
    exactly, for the parameters, the statistics, the gradients and the
    optimizer's moments (the layout ``train_fusion``'s resume reads)."""
    fmodel, data, params, stats, cfg, _ = _setup("v3s", True, 24, 24, b=2)
    assert "DualHead_0" in params and "head_tsdf" not in params
    path = str(tmp_path / "stacked.ckpt")
    save_checkpoint({"params": params, "batch_stats": stats}, path)
    net = fusionnet_from_checkpoint(path, cfg).eval()
    assert net.stack_heads
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in data.items()}).numpy()
    np.testing.assert_allclose(got, _eval(fmodel, params, stats, data),
                               atol=1e-5, rtol=0)

    p2, s2 = to_flax(net)
    for a, b in ((p2, params), (s2, stats)):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        for x, y in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(x, np.asarray(y))
    back = from_flax_tree(net, p2)
    for n, p in net.named_parameters():
        np.testing.assert_array_equal(back[n], p.detach().numpy())

    opt = get_optimizer(Config({"name": "rmsprop", "momentum": 0.9}), net,
                        lambda count: 1e-3)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.state_dict_flax()
    assert state["0"]["nu"]["DualHead_0"]["Block_0"]["Conv_0"][
        "kernel"].shape[0] == 2
    opt2 = get_optimizer(Config({"name": "rmsprop", "momentum": 0.9}),
                         load_flax(build_fusion_net(cfg), params, stats),
                         lambda count: 1e-3)
    opt2.load_state_dict_flax(state)
    for x, y in zip(leaves(opt2.state_dict_flax()), leaves(state)):
        np.testing.assert_array_equal(x, y)


def test_factory_builds_v1_v2_where_the_jax_factory_raises():
    """The port's ``build_fusion_net`` builds v1 and v2 (no ``dropout``
    keyword); the JAX factory passes ``dropout=`` to classes that do not
    take it (ROADMAP Queue 3, a note on the reference). Train mode draws
    its channel dropout from the module's generator."""
    for name, cls in (("v1", FusionNetV1), ("v2", FusionNetV2)):
        cfg = _config(name, True, gf=2)
        assert isinstance(build_fusion_net(cfg), cls)
        with pytest.raises(TypeError, match="dropout"):
            jfusionnet.build_fusion_net(cfg)
    assert isinstance(build_fusion_net(_config("v3", True)), FusionNetV3)
    with pytest.raises(ValueError, match="v4"):
        build_fusion_net(_config("v4", True))
    net = build_fusion_net(_config("v2", True, gf=2)).train()
    data = {k: torch.from_numpy(v) for k, v in _fusion_inputs(
        np.random.RandomState(2), 1, 16, 16, N_POINTS, True).items()}
    with pytest.raises(RuntimeError, match="generator"):
        net(data)
    net.set_dropout_generator(torch.Generator().manual_seed(3))
    a = net(data)
    net.set_dropout_generator(torch.Generator().manual_seed(3))
    assert torch.equal(net(data), a)
