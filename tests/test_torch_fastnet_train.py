"""The port's matmul-form training forward
(``segfusion_tpu_torch.models.fusionnet_fast.apply_v3_train``) against the
JAX package's ``fusionnet_fast.apply_v3_train``: the output, the new
BatchNorm running statistics and the gradients, with dropout 0 (the two
packages draw from other random streams); then dropout's channel
broadcast (the port draws the eager module's masks in the eager module's
order) and the missing-generator error.

Both are held to Flax's train forward evaluated in float64 on the same
parameters (``tests/test_torch_train_net._flax_f64``, the loss
``sum(out * weight)``), and the port to the JAX executor within the sum
of the two packages' distances from it: the JAX executor's float32 sums
at batch 1 are the noisier (gf 3, 32x32: its gradients lie 1.6-2.9 from
float64 on gradients up to 216, the port's 3.4e-4-8.0e-4; its output
7.5e-5, the port's 1.3e-5), so tests/test_fastnet_train.py's bounds
(rtol 2e-4 / atol 2e-5) hold the port's output and statistics to the
float64 reference, and its gradients are held as
``tests/test_torch_train_net.py`` holds the eager module's (2e-5 of the
largest gradient).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.models import fusionnet_fast as jff
from segfusion_tpu_torch.models import fusionnet_fast as ff
from segfusion_tpu_torch.utils.convert import (flax_tree, fusionnet_from_flax,
                                               to_flax)
from tests.test_torch_nets import one_torch_thread  # noqa: F401
from tests.test_torch_train_net import _flax_f64, _max_err, _setup

leaves = jax.tree_util.tree_leaves
GF = 3


def _jax(data, params, stats, use_semantics, weight, dtype):
    """JAX's (est, grads, new stats) for the loss sum(est * weight)."""
    jdata = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(p):
        est, new_stats = jff.apply_v3_train(
            p, stats, jdata, None, growth_factor=GF,
            use_semantics=use_semantics, n_points=weight.shape[-1],
            dropout_rate=0.0, dtype=dtype)
        est = est.reshape(weight.shape)
        return jnp.sum(est * weight), (est, new_stats)

    (_, (est, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return np.asarray(est), grads, new_stats


def _port(data, params, stats, cfg, weight, dtype, generator=None):
    net = fusionnet_from_flax(params, stats, cfg).train()
    est = ff.apply_v3_train(net, {k: torch.from_numpy(v)
                                  for k, v in data.items()},
                            dtype=dtype, generator=generator)
    est = est.reshape(weight.shape)
    (est * torch.from_numpy(weight)).sum().backward()
    grads = flax_tree(net, {n: p.grad for n, p in net.named_parameters()})
    return est.detach().numpy(), grads, to_flax(net)[1]


def _assert_trees_close(a, b, **tol):
    assert jax.tree_util.tree_structure(a) == \
        jax.tree_util.tree_structure(b)
    for x, y in zip(leaves(a), leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64), **tol)


@pytest.mark.parametrize("use_semantics", [True, False],
                         ids=["sem", "nosem"])
def test_train_forward_stats_and_grads_match_jax(use_semantics):
    """f32, dropout 0 (gf 3, 32x32): the port's output and new running
    statistics within rtol 2e-4 / atol 2e-5 of the reference (the JAX
    executor's statistics too), its gradients within 2e-5 of the largest;
    on the output and the gradients the port no further from the
    reference than the JAX executor, and from the JAX executor no further
    than the sum of the two errors."""
    fmodel, data, params, stats, weight, cfg = _setup(GF, use_semantics)
    _, ref_out, ref_grads, ref_stats = _flax_f64(fmodel, data, params,
                                                 stats, weight)
    j_out, j_grads, j_stats = _jax(data, params, stats, use_semantics,
                                   weight, jnp.float32)
    out, grads, new_stats = _port(data, params, stats, cfg, weight,
                                  torch.float32)
    assert out.shape == j_out.shape == ref_out.shape
    np.testing.assert_allclose(out, ref_out, rtol=2e-4, atol=2e-5)
    _assert_trees_close(new_stats, ref_stats, rtol=2e-4, atol=2e-5)
    _assert_trees_close(j_stats, ref_stats, rtol=2e-4, atol=2e-5)
    gmax = max(float(np.abs(g).max()) for g in leaves(ref_grads))
    assert _max_err(grads, ref_grads) <= 2e-5 * gmax
    for port, jx, ref in ((out, j_out, ref_out),
                          (grads, j_grads, ref_grads)):
        err_port, err_jax = _max_err(port, ref), _max_err(jx, ref)
        assert err_port <= err_jax, (err_port, err_jax)
        assert _max_err(port, jx) <= err_port + err_jax


def test_bf16_train_tracks_jax_bf16():
    """bf16 on f32 masters (the Pipeline's bf16 training), both packages
    against the f64 reference: the port's error on the output and the
    gradients at most the JAX executor's (measured 0.106 / 0.158 and
    74.5 / 592), on the new statistics at most twice its (1.67e-4 /
    1.03e-4: bf16 activations feed both), and the two outputs within the
    sum of their errors."""
    fmodel, data, params, stats, weight, cfg = _setup(GF, True)
    _, ref_out, ref_grads, ref_stats = _flax_f64(fmodel, data, params,
                                                 stats, weight)
    j_out, j_grads, j_stats = _jax(data, params, stats, True, weight,
                                   jnp.bfloat16)
    out, grads, new_stats = _port(data, params, stats, cfg, weight,
                                  torch.bfloat16)
    err_port = np.abs(out - ref_out).max()
    err_jax = np.abs(j_out - ref_out).max()
    assert 0 < err_jax < 0.5
    assert err_port <= err_jax
    assert np.abs(out - j_out).max() <= err_port + err_jax
    assert _max_err(grads, ref_grads) <= _max_err(j_grads, ref_grads)
    assert _max_err(new_stats, ref_stats) <= \
        2.0 * _max_err(j_stats, ref_stats)


def test_dropout_draws_the_eager_masks_per_channel():
    """Dropout 0.5 (f32): one keep draw per (frame, channel), the eager
    module's draws in its order, so from one seed the matmul form and the
    eager train-mode module give the same output; another seed another
    output; a dropped channel is zero at every pixel."""
    data, params, stats, cfg = _dropout_setup(0.5)
    inputs = {k: torch.from_numpy(v) for k, v in data.items()}

    def fused(seed):
        net = fusionnet_from_flax(params, stats, cfg).train()
        return ff.apply_v3_train(
            net, inputs, dtype=torch.float32,
            generator=torch.Generator().manual_seed(seed)).detach()

    eager = fusionnet_from_flax(params, stats, cfg).train()
    eager.set_dropout_generator(torch.Generator().manual_seed(7))
    a = fused(7)
    with torch.no_grad():
        want = eager(inputs).reshape(a.shape)
    torch.testing.assert_close(a, want, rtol=0, atol=1e-4)
    assert not torch.allclose(a, fused(8))

    walk = ff._TrainWalk(torch.float32, "dots9",
                         torch.Generator().manual_seed(0))
    layer = eager.FusionHead_0.Block_0.drop
    y = walk.dropout(torch.ones(2, 5, 6, 64), layer)
    per_channel = y.amax((1, 2))
    assert torch.equal(y, per_channel[:, None, None].expand_as(y))
    assert set(per_channel.unique().tolist()) == {0.0, 2.0}


def test_missing_generator_raises():
    """Dropout above 0 without a generator raises, as the JAX executor
    does without an rng."""
    data, params, stats, cfg = _dropout_setup(0.2)
    net = fusionnet_from_flax(params, stats, cfg).train()
    with pytest.raises(ValueError, match="generator"):
        ff.apply_v3_train(net, {k: torch.from_numpy(v)
                                for k, v in data.items()})


def _dropout_setup(rate):
    """gf 3 without semantics, FUSION_MODEL dropout ``rate``."""
    _, data, params, stats, _, cfg = _setup(GF, False)
    cfg.dropout = rate
    return data, params, stats, cfg
