"""The port's stage-2 segmentation training against the JAX package's,
on the CPU.

``train_segmentation`` at stage 2 on configs/segmentation/synthetic_small
(1 epoch of 3 steps, 32x32): encoders and eASPP transplanted from a
stage-1 rgb and a tof checkpoint, random modality masking at mask_prob
1.0 (every step's image zeroed), the layer3 dropout off. The two
trainers start from the JAX trainer's own initial draw (its
``model.init`` under the seed's key, given to the port), so the
transplant acts on the same tree in both. The tolerances are those of
tests/test_torch_segmentation.py (f32 trajectories of a random net).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from segfusion_tpu.config import load_config as j_load_config
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.models.adapnet import AdapNet as JAdapNet
from segfusion_tpu.utils import checkpoints as jck
from segfusion_tpu.utils import workspace as j_workspace
from segfusion_tpu_torch import train_segmentation as port_train_seg
from segfusion_tpu_torch.config import load_config
from segfusion_tpu_torch.utils.convert import adapnet_from_flax, to_flax
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SMALL = os.path.join(ROOT, "configs", "segmentation",
                         "synthetic_small.yaml")
leaves = jax.tree_util.tree_leaves


def _stage1_checkpoints(tmp, n_classes, seed):
    """rgb and tof stage-1 checkpoints with random weights."""
    rng = np.random.RandomState(seed)
    paths = {}
    for mod in ("rgb", "tof"):
        params, stats = random_variables(
            JAdapNet(n_classes=n_classes, stage=1), rng,
            jnp.zeros((1, 32, 32, 3)))
        paths[mod] = str(tmp / f"{mod}.ckpt")
        jck.save_checkpoint({"params": params, "batch_stats": stats},
                            paths[mod])
    return paths


def _stage2_config(load, path, ckpts):
    cfg = load(CFG_SMALL)
    cfg.SETTINGS.experiment_path = path
    cfg.SEMANTIC_2D_MODEL.update(stage=2, resn50_dropout=False,
                                 pretrained_rgb=ckpts["rgb"],
                                 pretrained_tof=ckpts["tof"])
    cfg.TRAINING.optimization.update(random_mask=True, mask_prob=1.0)
    return cfg


def _jax_initial_draw(cfg):
    """The JAX trainer's ``model.init`` (the key split from the seed)."""
    rng = jax.random.PRNGKey(int(cfg.SETTINGS.seed))
    _, init_rng = jax.random.split(rng)
    x = jnp.zeros((1, 32, 32, 3))
    v = JAdapNet(n_classes=4, stage=2, resn50_dropout=False).init(
        init_rng, x, x, train=False)
    return v["params"], v["batch_stats"]


class _Log:
    """A workspace stand-in that keeps its log lines."""

    def __init__(self):
        self.lines = []

    def log(self, msg, mode="train"):
        self.lines.append(msg)


def test_stage2_transplant_takes_the_stage1_encoders(tmp_path):
    """The transplant writes rgb's encoder_mod1 / eASPP into encoder_mod1 /
    eASPP_mod1 and tof's into encoder_mod2 / eASPP_mod2, parameters only
    (the running statistics keep the initial ones, as in JAX), and leaves
    the SSMA modules and the decoder as they were."""
    ckpts = _stage1_checkpoints(tmp_path, 4, seed=1)
    cfg = _stage2_config(load_config, str(tmp_path / "port"), ckpts)
    model = port_train_seg.new_adapnet(cfg.SEMANTIC_2D_MODEL, 3)
    before_p, before_s = to_flax(model)
    log = _Log()
    port_train_seg._initial_weights(model, cfg.SEMANTIC_2D_MODEL, log)
    assert log.lines == ["transplanted stage-1 rgb+tof encoders"]
    after_p, after_s = to_flax(model)
    rgb = jck.load_checkpoint(ckpts["rgb"])["params"]
    tof = jck.load_checkpoint(ckpts["tof"])["params"]
    for dst, src in (("encoder_mod1", rgb["encoder_mod1"]),
                     ("eASPP_mod1", rgb["eASPP"]),
                     ("encoder_mod2", tof["encoder_mod1"]),
                     ("eASPP_mod2", tof["eASPP"])):
        for g, w in zip(leaves(after_p[dst]), leaves(src)):
            np.testing.assert_array_equal(g, w)
    for key in ("ssma_res", "decoder"):
        for g, w in zip(leaves(after_p[key]), leaves(before_p[key])):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(leaves(after_s), leaves(before_s)):
        np.testing.assert_array_equal(g, w)


def test_stage2_training_matches_jax(tmp_path, monkeypatch):
    """Stage 2 with the transplant and mask_prob 1.0: every step's image
    input is zeros in the port (as the JAX trainer's first draw, r <= 1.0,
    always zeroes it), and the epoch's loss and validation metrics agree
    with the JAX trainer's (loss rtol 3e-2, measured 1.1e-2; metrics
    within 0.05, NaN where both score no class)."""
    import train_segmentation as jax_train_seg

    ckpts = _stage1_checkpoints(tmp_path, 4, seed=1)
    scalars = []
    monkeypatch.setattr(j_workspace.Workspace, "add_scalar",
                        lambda self, tag, value, step=0:
                        scalars.append((tag, float(value))))
    jcfg = _stage2_config(j_load_config, str(tmp_path / "jax"), ckpts)
    jax_train_seg.train({}, jcfg)

    params, stats = _jax_initial_draw(jcfg)
    monkeypatch.setattr(port_train_seg, "new_adapnet",
                        lambda cfg, seed: adapnet_from_flax(params, stats,
                                                            cfg))
    monkeypatch.setattr(port_train_seg, "get_data",
                        lambda name, data_cfg, device: JSynthetic(data_cfg))
    seen = []
    modalities = port_train_seg._modalities

    def record(model, inputs, in_key):
        if model.training:
            seen.append(float(inputs["image"].abs().max()))
        return modalities(model, inputs, in_key)
    monkeypatch.setattr(port_train_seg, "_modalities", record)
    cfg = _stage2_config(load_config, str(tmp_path / "port"), ckpts)
    _, ws, history = port_train_seg.train_segmentation(cfg, "cpu")

    assert seen == [0.0, 0.0, 0.0]
    j_loss = [v for t, v in scalars if t == "Train/loss_t"]
    np.testing.assert_allclose(history["train_loss"], j_loss, rtol=3e-2)
    for k in ("Acc", "Mean IoU"):
        want = [v for t, v in scalars if t == f"Val/{k.replace(' ', '_')}"]
        got = [m[k] for m in history["val"]]
        np.testing.assert_allclose(got, want, atol=0.05)
    assert "last.ckpt" in os.listdir(ws.model_path)
