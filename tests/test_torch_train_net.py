"""FusionNet v3 in train mode: the port against Flax
``apply(train=True, mutable=["batch_stats"])`` under ``jax.value_and_grad``
(the output, the loss, every parameter gradient and the new running
statistics), with the parameters carried across by ``utils/convert.py``;
bf16 against the JAX package's bf16 training forward
(``fusionnet_fast.apply_v3_train``); dropout from an explicit generator.

The reference is Flax evaluated in float64. Training runs one frame at a
time (batch 1), where the image-level branch of each VortexPooling
normalises a map that is constant over H and W: its variance is 0, and
Flax's float32 sums over the broadcast map leave a rounding residue that
``rsqrt(var + eps)`` amplifies into the gradients (Flax float32 against
float64: 2.3 on gradients of magnitude 142). The port normalises the
per-sample values, where the statistics are exact. Dropout is 0 in the
parity runs (the JAX and torch random streams differ), as in the JAX
package's own tests.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.models import fusionnet_fast as ff
from segfusion_tpu.models.fusionnet import FusionNetV3 as JFusionNetV3
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models.fusionnet import Dropout
from segfusion_tpu_torch.utils.convert import (flax_tree, fusionnet_from_flax,
                                               to_flax)
from tests.test_torch_nets import (_fusion_inputs,  # noqa: F401
                                   one_torch_thread, random_variables)

H = W = 32
N_POINTS = 9
leaves = jax.tree_util.tree_leaves


def _setup(gf, use_semantics, seed=0):
    rng = np.random.RandomState(seed)
    fmodel = JFusionNetV3(n_points=N_POINTS, use_semantics=use_semantics,
                          output_scale=1.0, growth_factor=gf, dropout=0.0)
    data = _fusion_inputs(rng, 1, H, W, N_POINTS, use_semantics)
    params, stats = random_variables(
        fmodel, rng, {k: jnp.asarray(v) for k, v in data.items()})
    weight = rng.randn(1, H, W, N_POINTS).astype(np.float32)
    cfg = Config({"name": "v3", "n_points": N_POINTS,
                  "use_semantics": use_semantics, "output_scale": 1.0,
                  "growth_factor": gf, "dropout": 0.0})
    return fmodel, data, params, stats, weight, cfg


def _flax_f64(fmodel, data, params, stats, weight):
    """(loss, output, grads, new batch_stats) of Flax train mode in f64
    for the loss sum(output * weight)."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        p64, s64, d64 = f64(params), f64(stats), f64(data)

        def loss_fn(p):
            out, mut = fmodel.apply({"params": p, "batch_stats": s64}, d64,
                                    train=True, mutable=["batch_stats"])
            return jnp.sum(out * weight.astype(np.float64)), (
                out, mut["batch_stats"])

        (loss, (out, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p64)
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        return float(loss), np.asarray(out), host(grads), host(new_stats)


def _port(params, stats, cfg, data, weight, compute_dtype=None):
    net = fusionnet_from_flax(params, stats, cfg).train()
    net.compute_dtype = compute_dtype
    out = net({k: torch.from_numpy(v) for k, v in data.items()})
    loss = (out * torch.from_numpy(weight)).sum()
    loss.backward()
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    return float(loss), out.detach().numpy(), grads, to_flax(net)[1]


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("use_semantics", [True, False])
def test_train_mode_matches_flax(use_semantics):
    """gf 3, 32x32, f32, dropout 0, against Flax in f64: output within
    atol 1e-4, loss within rtol 1e-5, every gradient within 2e-5 of the
    largest gradient magnitude (measured: 4e-4 of 142), new running
    statistics within 1e-5 (measured 1.3e-7)."""
    fmodel, data, params, stats, weight, cfg = _setup(3, use_semantics)
    ref_loss, ref_out, ref_grads, ref_stats = _flax_f64(fmodel, data,
                                                        params, stats,
                                                        weight)
    loss, out, grads, new_stats = _port(params, stats, cfg, data, weight)
    np.testing.assert_allclose(out, ref_out, atol=1e-4)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(ref_grads)
    gmax = max(float(np.abs(g).max()) for g in leaves(ref_grads))
    assert _max_err(grads, ref_grads) <= 2e-5 * gmax
    assert jax.tree_util.tree_structure(new_stats) == \
        jax.tree_util.tree_structure(ref_stats)
    assert _max_err(new_stats, ref_stats) <= 1e-5
    assert _max_err(new_stats, stats) > 1e-3      # the statistics moved


def test_bf16_train_matches_apply_v3_train():
    """bf16 compute on f32 master weights against the JAX package's bf16
    training forward (``apply_v3_train``, the path its Pipeline trains
    bf16 v3 through): neither is bit-exact, so both are held to the f64
    Flax reference. The port's error on the output, the gradients and the
    new statistics is at most 1.25x that of apply_v3_train (measured:
    0.129 / 0.153 on the output, 70.6 / 1176 on the gradients, 8.3e-5 /
    1.1e-4 on the statistics), and the two outputs lie within the sum of
    their errors."""
    fmodel, data, params, stats, weight, cfg = _setup(3, True)
    _, ref_out, ref_grads, ref_stats = _flax_f64(fmodel, data, params,
                                                 stats, weight)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(p):
        est, new_stats = ff.apply_v3_train(
            p, stats, jdata, None, growth_factor=3, use_semantics=True,
            n_points=N_POINTS, output_scale=1.0, dropout_rate=0.0,
            dtype=jnp.bfloat16)
        est = est.reshape(weight.shape)
        return jnp.sum(est * weight), (est, new_stats)

    (_, (j_out, j_stats)), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    _, out, grads, new_stats = _port(params, stats, cfg, data, weight,
                                     torch.bfloat16)
    j_out = np.asarray(j_out)
    err_port = np.abs(out - ref_out).max()
    err_jax = np.abs(j_out - ref_out).max()
    assert err_port <= 1.25 * err_jax
    assert np.abs(out - j_out).max() <= err_port + err_jax
    assert _max_err(grads, ref_grads) <= 1.25 * _max_err(j_grads, ref_grads)
    assert _max_err(new_stats, ref_stats) <= \
        1.25 * _max_err(j_stats, ref_stats)


def test_master_weights_infer_like_the_cast_net():
    """A float32 net computing in bfloat16 infers bit-identically to the
    same net cast to bfloat16 (the inference pipelines' form)."""
    _, data, params, stats, _, cfg = _setup(2, True, seed=1)
    master = fusionnet_from_flax(params, stats, cfg).eval()
    master.compute_dtype = torch.bfloat16
    cast = fusionnet_from_flax(params, stats, cfg).to(torch.bfloat16).eval()
    inputs = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        assert torch.equal(master(inputs), cast(inputs))
    assert master.Pred_0.Conv_0.weight.dtype == torch.float32


def test_dropout_draws_from_its_generator():
    """Channel dropout: one keep draw per (sample, channel), kept values
    scaled by 1 / (1 - rate); the same seed gives the same mask, the
    global RNG is untouched; identity at inference; train mode without a
    generator raises."""
    drop = Dropout(0.5).train()
    x = torch.rand(2, 64, 8, 8) + 1.0
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    state = torch.get_rng_state()
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x), y)
    assert torch.equal(torch.get_rng_state(), state)
    kept = y[:, :, :1, :1] != 0
    assert torch.equal(y != 0, kept.expand_as(y))      # whole channels
    assert torch.allclose(y[kept.expand_as(y)], 2 * x[kept.expand_as(y)])
    assert 0.25 < kept.float().mean() < 0.75
    assert torch.equal(drop.eval()(x), x)
