"""Port parity for per-frame training with gradient accumulation:
``utils/optim.MultiSteps`` against ``optax.MultiSteps``, and
``train_fusion`` with ``TRAINING.optimization.use_sequence: false`` and
``accumulation_steps: 2`` (one ``Pipeline.fuse_training`` step a frame,
the mean of two frames' gradients applied every second frame) against
the JAX package's ``train_fusion.py``, on the CPU.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from segfusion_tpu.config import Config as JConfig
from segfusion_tpu.config import load_config
from segfusion_tpu.utils.optim import get_optimizer as j_get_optimizer
from segfusion_tpu.utils.schedulers import get_schedule as j_get_schedule
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.utils.convert import flax_tree, from_flax_tree
from segfusion_tpu_torch.utils.optim import MultiSteps, get_optimizer
from segfusion_tpu_torch.utils.schedulers import get_schedule
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_train_pipeline import _max_err

leaves = jax.tree_util.tree_leaves
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SMALL = os.path.join(ROOT, "configs", "fusion", "synthetic_small.yaml")


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(k):
    """``MultiSteps(Optimizer(rmsprop, weight decay, clipping, poly_lr),
    k)`` against ``optax.MultiSteps(chain(clip_by_global_norm(1.0),
    rmsprop), every_k_schedule=k)`` on the same 7 gradients (norms above
    and below the clip): parameters within rtol 1e-6 (+ 1e-6 of a leaf's
    largest magnitude) after every step, untouched between the k-th
    ones; the state in optax's layout within the same bound (counts
    exact); an optimizer restored from the optax state after step 4
    continues in step."""
    from tests.test_torch_train_utils import _net_and_params

    opt_cfg = JConfig({"name": "rmsprop", "lr": 1e-3, "momentum": 0.9,
                       "weight_decay": 0.01, "eps": 1e-9, "alpha": 0.99})
    sched = {"name": "poly_lr", "max_iter": 20, "warmup_iters": 2}
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(1.0),
        j_get_optimizer(opt_cfg, learning_rate=j_get_schedule(1e-3, sched))),
        every_k_schedule=k)
    net, params = _net_and_params()

    def port_opt(module):
        return MultiSteps(get_optimizer(Config(opt_cfg), module,
                                        get_schedule(1e-3, sched),
                                        clipping=True), k)

    opt = port_opt(net)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    apply = jax.jit(lambda p, s, g: (lambda u, s2: (
        optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    rng = np.random.RandomState(4)
    scales = [0.5, 0.002, 0.3, 0.001, 0.05, 0.4, 0.2]
    all_g = [jax.tree_util.tree_map(
        lambda x, s=s: (rng.randn(*x.shape) * s).astype(np.float32), params)
        for s in scales]

    def step(o, module, g):
        values = from_flax_tree(module, g)
        for n, p in module.named_parameters():
            p.grad = torch.as_tensor(values[n].copy())
        o.step()

    def check(module, want):
        got = flax_tree(module, dict(module.named_parameters()))
        for a, b in zip(leaves(got), leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())

    before = flax_tree(net, dict(net.named_parameters()))
    for i, g in enumerate(all_g):
        jparams, state = apply(jparams, state, g)
        step(opt, net, g)
        check(net, jparams)
        now = flax_tree(net, dict(net.named_parameters()))
        assert (_max_err(now, before) == 0.0) == bool((i + 1) % k)
        before = now
        if i == 3:
            net2 = copy.deepcopy(net)
            opt2 = port_opt(net2)
            opt2.load_state_dict_flax(jax.tree_util.tree_map(
                np.asarray, serialization.to_state_dict(state)))
    want = jax.tree_util.tree_map(np.asarray,
                                  serialization.to_state_dict(state))
    got = opt.state_dict_flax()
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    assert (opt.mini_step, opt.gradient_step) == (len(scales) % k,
                                                  len(scales) // k)
    for a, b in zip(leaves(got), leaves(want)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    for g in all_g[4:]:
        step(opt2, net2, g)
    check(net2, jparams)


def trainer_pair(tmp_path, monkeypatch, settings, optimization):
    """synthetic_small through the JAX package's ``train_fusion.py`` and
    the port's, both from one pretrained checkpoint (the JAX init), with
    dropout 0, the SGD rule (momentum 0.9, lr 1e-3: see below), the given
    SETTINGS and TRAINING.optimization overrides, the port reading the
    JAX Synthetic frames. Returns (initial params, JAX params, port net,
    port workspace, the two trainers' logged losses)."""
    import train_fusion as jax_entry
    from segfusion_tpu.core.pipeline import Pipeline as JPipeline
    from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
    from segfusion_tpu.utils.checkpoints import save_checkpoint
    from segfusion_tpu_torch import train_fusion as port_entry

    pre = str(tmp_path / "init.ckpt")

    def configure(path):
        cfg = load_config(CFG_SMALL)
        cfg.SETTINGS.update(experiment_path=path, eval_freq=100, log_freq=5,
                            **settings)
        cfg.FUSION_MODEL.update(dropout=0.0, pretrained=pre)
        cfg.TRAINING.optimizer.update(name="sgd", lr=1e-3)
        cfg.TRAINING.optimization.update(**optimization)
        return cfg

    params, stats = JPipeline(load_config(CFG_SMALL)).init_fusion_params(
        jax.random.PRNGKey(3), 48, 48)
    save_checkpoint({"params": params, "batch_stats": stats}, pre)
    jparams, _ = jax_entry.train_fusion({}, configure(str(tmp_path / "j")))
    monkeypatch.setattr(port_entry, "get_data",
                        lambda name, data_cfg, device: JSynthetic(data_cfg))
    net, ws = port_entry.train_fusion(Config(configure(str(tmp_path / "t"))),
                                      device="cpu")

    def losses(log_dir):
        with open(os.path.join(log_dir, "train.log")) as f:
            return [float(line.rsplit("loss", 1)[1]) for line in f
                    if ": loss " in line]
    jlog = os.path.join(str(tmp_path / "j"), os.listdir(
        str(tmp_path / "j"))[0], "logs")
    return params, jparams, net, ws, (losses(ws.log_path), losses(jlog))


def assert_trained_alike(params, jparams, net, logged):
    """The port's parameters within 0.05 of the largest parameter move
    from the JAX trainer's, and the logged losses within 1e-3."""
    got = flax_tree(net, dict(net.named_parameters()))
    move = _max_err(jparams, params)
    assert move > 0
    assert _max_err(got, jparams) <= 0.05 * move, (_max_err(got, jparams),
                                                  move)
    tl, jl = logged
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, atol=1e-3)


def test_train_fusion_per_frame_matches_jax(tmp_path, monkeypatch):
    """synthetic_small (10 frames of 48x48, weight decay, clipping,
    poly_lr) with ``use_sequence: false`` and ``accumulation_steps: 2``
    (:func:`trainer_pair`); the SGD rule in place of the config's
    rmsprop, which steps each element by about its rate whatever its
    gradient, so elements whose f32 gradient is rounding noise in either
    trainer would part by the whole move (rmsprop itself is held to optax
    above). last.ckpt's optimizer state has ``optax.MultiStepsState``'s
    layout and counts (5 updates, no mini-step pending) and restores into
    the JAX trainer's optax state; the parameters and losses as in
    :func:`assert_trained_alike` (measured: 2.8e-4 of the move; the losses
    equal to the logged six digits)."""
    from segfusion_tpu.utils import checkpoints as jck
    from segfusion_tpu_torch.utils.checkpoints import load_checkpoint

    params, jparams, net, ws, logged = trainer_pair(
        tmp_path, monkeypatch, {},
        {"use_sequence": False, "accumulation_steps": 2})
    last = load_checkpoint(os.path.join(ws.model_path, "last.ckpt"))
    state = last["opt_state"]
    assert set(state) == {"mini_step", "gradient_step", "inner_opt_state",
                          "acc_grads", "skip_state"}
    assert (int(state["mini_step"]), int(state["gradient_step"])) == (0, 5)
    assert int(state["inner_opt_state"]["1"]["1"]["1"]["count"]) == 5
    assert not any(np.abs(x).max() for x in leaves(state["acc_grads"]))
    cfg = load_config(CFG_SMALL)
    cfg.TRAINING.optimizer.update(name="sgd", lr=1e-3)
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(1.0), j_get_optimizer(
            cfg.TRAINING.optimizer, learning_rate=j_get_schedule(
                1e-3, cfg.TRAINING.scheduler))), every_k_schedule=2)
    restored = jck.restore_into(tx.init(jparams), state)
    assert int(restored.gradient_step) == 5
    assert_trained_alike(params, jparams, net, logged)
