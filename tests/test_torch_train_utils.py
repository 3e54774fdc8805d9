"""The training utilities of the port against the JAX package, on the same
numpy inputs made from a seed: ``fusion_loss`` and the cross-entropy
family (values and gradients against ``jax.grad``), every schedule step
by step, and each of the 7 optimizers over several updates against the
optax chain the JAX trainer builds (global-norm clipping, weight decay,
the rule at a scheduled rate), with its state in optax's layout."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from segfusion_tpu.config import Config as JConfig
from segfusion_tpu.models.fusionnet import FusionNetV3 as JFusionNetV3
from segfusion_tpu.utils import losses as jlosses
from segfusion_tpu.utils.optim import get_optimizer as j_get_optimizer
from segfusion_tpu.utils.schedulers import get_schedule as j_get_schedule
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.utils import losses
from segfusion_tpu_torch.utils.convert import (flax_tree, from_flax_tree,
                                               fusionnet_from_flax)
from segfusion_tpu_torch.utils.optim import get_optimizer
from segfusion_tpu_torch.utils.schedulers import get_schedule
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

leaves = jax.tree_util.tree_leaves


def _value_and_grad_port(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return float(out), ts[0].grad.numpy()


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [True, False])
def test_fusion_loss_matches_jax(with_mask):
    """Value within rtol 1e-6, gradient w.r.t. the estimate within atol
    1e-7 (f32, the same reductions in another order)."""
    rng = np.random.RandomState(0)
    b, n, p = 2, 64, 5
    est = (rng.randn(b, n, p) * 0.1).astype(np.float32)
    target = (rng.randn(b, n, p) * 0.1).astype(np.float32)
    mask = rng.rand(b, n) > 0.3 if with_mask else None
    kw = dict(w_l1=1.0, w_l2=10.0, w_cos=0.1)
    jm = None if mask is None else jnp.asarray(mask)
    jv, jg = jax.value_and_grad(
        lambda e: jlosses.fusion_loss(e, jnp.asarray(target), jm, **kw))(
            jnp.asarray(est))
    tm = None if mask is None else torch.as_tensor(mask)
    tv, tg = _value_and_grad_port(
        lambda e: losses.fusion_loss(e, torch.as_tensor(target), tm, **kw),
        est)
    assert tv == pytest.approx(float(jv), rel=1e-6)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-7)


def test_fusion_loss_all_masked_is_zero():
    """A padded frame (mask all False) adds zero loss and zero gradient."""
    est = torch.randn(1, 16, 5, requires_grad=True)
    loss = losses.fusion_loss(est, torch.randn(1, 16, 5),
                              torch.zeros(1, 16, dtype=torch.bool))
    loss.backward()
    assert float(loss) == 0.0 and not est.grad.any()


@pytest.mark.parametrize("name", ["cross_entropy",
                                  "bootstrapped_cross_entropy",
                                  "multi_scale_cross_entropy"])
def test_cross_entropy_family_matches_jax(name, tmp_path):
    """Each CE loss through ``get_loss_function`` (class weights from a
    text file): value within rtol 1e-5, logit gradient within atol 1e-6."""
    rng = np.random.RandomState(1)
    c = 6
    logits = rng.randn(2, 8, 8, c).astype(np.float32)
    labels = rng.randint(-1, c + 1, (2, 8, 8)).astype(np.int32)
    wpath = tmp_path / "w.txt"
    np.savetxt(wpath, rng.uniform(0.5, 2.0, c))
    cfg = {"name": name, "weight": str(wpath), "min_K": 20, "loss_th": 1.5}
    jfn = jlosses.get_loss_function(cfg)
    pfn = losses.get_loss_function(cfg)
    if name == "multi_scale_cross_entropy":
        heads = [logits, logits * 0.5, logits[..., ::-1].copy()]
        jv, jg = jax.value_and_grad(lambda x: jfn(
            [x, jnp.asarray(heads[1]), jnp.asarray(heads[2])],
            jnp.asarray(labels)))(jnp.asarray(logits))
        tv, tg = _value_and_grad_port(lambda x: pfn(
            [x, torch.as_tensor(heads[1]), torch.as_tensor(heads[2])],
            torch.as_tensor(labels)), logits)
    else:
        jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels)))(
            jnp.asarray(logits))
        tv, tg = _value_and_grad_port(
            lambda x: pfn(x, torch.as_tensor(labels)), logits)
    assert tv == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-6)


# -- schedules ----------------------------------------------------------------

SCHEDULES = [
    {"name": "constant_lr"},
    {"name": "poly_lr", "max_iter": 40, "gamma": 0.9},
    {"name": "multi_step", "milestones": [5, 12, 12, 30], "gamma": 0.5},
    {"name": "step", "step_size": 7, "gamma": 0.3},
    {"name": "cosine_annealing", "T_max": 30, "eta_min": 1e-5},
    {"name": "exp_lr", "gamma": 0.9},
    {"name": "poly_lr", "max_iter": 40, "warmup_iters": 10},
    {"name": "exp_lr", "gamma": 0.95, "warmup_iters": 6,
     "warmup_mode": "constant", "warmup_factor": 0.1},
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_schedule_matches_jax(cfg):
    """Steps 0..45 (past every milestone, warmup and horizon) within rtol
    1e-6 (JAX computes in f32)."""
    jsched = j_get_schedule(1e-3, cfg)
    psched = get_schedule(1e-3, cfg)
    for step in range(46):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        assert psched(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = ["sgd", "adam", "adamax", "adadelta", "adagrad", "rmsprop",
              "asgd"]


def _net_and_params(seed=0):
    fm = JFusionNetV3(n_points=3, use_semantics=False, growth_factor=2)
    dummy = {"tsdf_values": jnp.zeros((1, 8, 8, 3)),
             "tsdf_weights": jnp.zeros((1, 8, 8, 3)),
             "tsdf_frame": jnp.zeros((1, 8, 8, 1))}
    params, stats = random_variables(fm, np.random.RandomState(seed), dummy)
    cfg = Config({"name": "v3", "n_points": 3, "use_semantics": False,
                  "output_scale": 1.0, "growth_factor": 2})
    return fusionnet_from_flax(params, stats, cfg), params


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, weight_decay):
    """6 updates with the same gradients (global norms above and below
    the clip) at a poly_lr rate with warmup: parameters within rtol 1e-6
    (+ 1e-6 of the leaf's largest magnitude: a value crossing 0) after
    every update, and the optimizer state in optax's
    layout (flax ``to_state_dict`` of the JAX trainer's optax state)
    within rtol 1e-5 + 1e-6 of each leaf's largest magnitude (a momentum
    trace near 0 cancels). Then a fresh port optimizer restored from the optax
    state continues in step with optax."""
    opt_cfg = JConfig({"name": name, "lr": 1e-3, "momentum": 0.9,
                       "weight_decay": weight_decay, "eps": 1e-9,
                       "betas": [0.9, 0.99], "rho": 0.9, "alpha": 0.99})
    sched_cfg = {"name": "poly_lr", "max_iter": 20, "warmup_iters": 3}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     j_get_optimizer(opt_cfg,
                                     learning_rate=j_get_schedule(
                                         1e-3, sched_cfg)))
    net, params = _net_and_params()
    opt = get_optimizer(Config(opt_cfg), net, get_schedule(1e-3, sched_cfg),
                        clipping=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    apply = jax.jit(lambda p, s, g: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    rng = np.random.RandomState(2)

    def grads(scale):
        return jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * scale).astype(np.float32),
            params)

    def set_grads(g):
        values = from_flax_tree(net, g)
        for n, p in net.named_parameters():
            p.grad = torch.as_tensor(values[n].copy())

    def check_params():
        got = flax_tree(net, dict(net.named_parameters()))
        for a, b in zip(leaves(got), leaves(jparams)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())

    for i, scale in enumerate([0.5, 0.002, 0.3, 0.001, 0.05, 0.4]):
        g = grads(scale)
        jparams, state = apply(jparams, state, g)
        set_grads(g)
        opt.step()
        check_params()
        if i == 2:
            # resume: a fresh optimizer over a copy of the net, restored
            # from the optax state
            net2 = copy.deepcopy(net)
            opt2 = get_optimizer(Config(opt_cfg), net2, opt.schedule,
                                 clipping=True)
            opt2.load_state_dict_flax(jax.tree_util.tree_map(
                np.asarray, serialization.to_state_dict(state)))
    assert opt.count == 6
    want = jax.tree_util.tree_map(np.asarray,
                                  serialization.to_state_dict(state))
    got = opt.state_dict_flax()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(leaves(got), leaves(want)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    # the restored optimizer, run over the last 3 gradients again
    rng = np.random.RandomState(2)
    all_g = [grads(s) for s in [0.5, 0.002, 0.3, 0.001, 0.05, 0.4]]
    for g in all_g[3:]:
        values = from_flax_tree(net2, g)
        for n, p in net2.named_parameters():
            p.grad = torch.as_tensor(values[n].copy())
        opt2.step()
    got2 = flax_tree(net2, dict(net2.named_parameters()))
    for a, b in zip(leaves(got2), leaves(jparams)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())


def test_clip_by_global_norm_matches_optax():
    """Gradients above the norm scale to norm 1; below it they pass."""
    from segfusion_tpu_torch.utils.optim import clip_by_global_norm_
    rng = np.random.RandomState(3)
    for scale in (2.0, 0.01):
        g = [rng.randn(4, 3).astype(np.float32) * scale,
             rng.randn(7).astype(np.float32) * scale]
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(x) for x in g], optax.EmptyState())
        ps = [torch.zeros(x.shape, requires_grad=True) for x in g]
        for p, x in zip(ps, g):
            p.grad = torch.as_tensor(x)
        clip_by_global_norm_(ps, 1.0)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)
