"""Port parity for online training on the Replica layout:
``segfusion_tpu_torch.train_fusion`` against the JAX package's
``train_fusion.py`` on configs/fusion/replica_accuracy.yaml, on the CPU.

The tree is chip_smoke's writer (a Synthetic room, 8 frames of 48x48)
with its semantic sdf hdf at 5 cm written by h5py (tests/
test_torch_test_fusion.py's ``write_semantic_sdf``); the port runs with
h5py blocked, so its loader reads the gt grid and its Database writes the
``save_mode: test`` volumes through ``utils/hdf5.py``. Both trainers
start from one checkpoint, the port's seeded draw written in the Flax
format that both load, with f32 nets, dropout 0, gt labels and chunks
of 4 frames (two optimizer updates), the SGD rule in place of the
config's rmsprop (see tests/test_torch_train_fusion_flat.py: rmsprop
steps every element by about its rate, so elements whose f32 gradient
is rounding noise would part by the whole move).

Measured on an 8-core x86 CPU: the port's parameters part from the JAX
trainer's by 1.7% of the largest move (the update's norm by 3.2%), the
logged losses by 1e-5. Frames of 48x48, not 16x16: at 16x16 the
train-mode BatchNorm statistics run over so few pixels that the two
packages' f32 gradients part by a third of the update (31% of the
largest move, 36% of its norm). The port's draw, not the JAX entry
point's (``init_fusion_params(PRNGKey(0), 48, 48)``): from that one the
validation keeps almost no surface after two updates (IoU 0.007
against 0.22).
"""

import ast
import os
import sys

import numpy as np
import torch

import h5py
from segfusion_tpu.config import load_config
from segfusion_tpu_torch import train_fusion as port_entry
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models import seeded_init
from segfusion_tpu_torch.models.fusionnet import build_fusion_net
from segfusion_tpu_torch.utils.checkpoints import save_checkpoint
from segfusion_tpu_torch.utils.convert import flax_tree, to_flax
from segfusion_tpu_torch.utils.hdf5 import File
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_test_fusion import CFG_REPLICA, write_semantic_sdf
from tests.test_torch_train_pipeline import _max_err
from tests.test_torch_utils import jax_mcubes_private  # noqa: F401 (a fixture)


def _log(ws_root: str, name: str):
    run = os.listdir(ws_root)[0]
    with open(os.path.join(ws_root, run, "logs", name)) as f:
        return f.read().splitlines()


def _val_metrics(ws_root: str) -> dict:
    """The validation's ``Evaluated <scene>: {...}`` dict."""
    line = [ln for ln in _log(ws_root, "val.log") if "Evaluated room" in ln]
    assert len(line) == 1, line
    return {k: float(v) for k, v in ast.literal_eval(
        line[0].split(": ", 1)[1].replace("np.float64", "float")
        .replace("np.float32", "float")).items()}


def _losses(ws_root: str):
    return [float(ln.rsplit("loss", 1)[1]) for ln in _log(ws_root,
                                                           "train.log")
            if ": loss " in ln]


def test_train_fusion_on_replica_matches_jax(tmp_path, monkeypatch,
                                            jax_mcubes_private):
    """Per-update losses within 1e-3, the parameters within 0.05 of the
    largest parameter move (tests/test_torch_train_fusion_flat.py's
    bounds), the validation's geometry metrics within 1e-4 and its
    semantic metrics exact (test_entry_point_matches_jax's bounds); the
    ``.hf5`` volumes of both validations: the same files, datasets,
    dtypes, shapes and gzip level 9, the semantics equal, the TSDF and
    weights within 1e-4 (absolute and relative: f32 sums in another
    order); best.ckpt and last.ckpt written."""
    import train_fusion as jax_entry
    from chip_smoke import write_replica_tree

    root = str(tmp_path / "replica")
    lst, _ = write_replica_tree(root, (0,), 8, 48, "cpu", 0.1)
    write_semantic_sdf(root, 0, 0.05)
    pre = str(tmp_path / "init.ckpt")

    def configure(cfg, path):
        cfg.SETTINGS.update(experiment_path=path, eval_freq=100, log_freq=4)
        cfg.FUSION_MODEL.update(compute_dtype="float32", dropout=0.0,
                                pretrained=pre)
        cfg.TRAINING.update(n_epochs=1)
        cfg.TRAINING.optimizer.update(name="sgd", lr=1e-3)
        cfg.TRAINING.optimization.update(accumulation_steps=4)
        cfg.DATA.update(root_dir=root, train_scene_list=lst,
                        val_scene_list=lst, resx=48, resy=48,
                        semantic_strategy="gt")
        return cfg

    init = seeded_init(build_fusion_net(configure(
        Config(load_config(CFG_REPLICA)), "").FUSION_MODEL),
        torch.Generator().manual_seed(0))
    params, stats = to_flax(init)
    save_checkpoint({"params": params, "batch_stats": stats}, pre)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    jparams, _ = jax_entry.train_fusion(
        {}, configure(load_config(CFG_REPLICA), jroot))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        net, ws = port_entry.train_fusion(
            configure(Config(load_config(CFG_REPLICA)), proot), device="cpu")

    got = flax_tree(net, dict(net.named_parameters()))
    move = _max_err(jparams, params)
    assert move > 0
    assert _max_err(got, jparams) <= 0.05 * move, (_max_err(got, jparams),
                                                  move)
    tl, jl = _losses(proot), _losses(jroot)
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, atol=1e-3)

    want, have = _val_metrics(jroot), _val_metrics(proot)
    assert set(have) == set(want)
    for k, v in want.items():
        if k.startswith("sem"):
            assert have[k] == v, k
        else:
            assert abs(have[k] - v) <= 1e-4, (k, have[k], v)
    assert all(np.isfinite(v) for v in want.values())
    assert want["acc"] > 0.3

    jout = os.path.join(jroot, os.listdir(jroot)[0], "output")
    names = sorted(n for n in os.listdir(jout) if n.endswith(".hf5"))
    assert names == sorted(n for n in os.listdir(ws.output_path)
                           if n.endswith(".hf5"))
    assert len(names) == 6                # best_val and latest_val, 3 each
    for n in names:
        with h5py.File(os.path.join(jout, n), "r") as fj, \
                File(os.path.join(ws.output_path, n), "r") as fp:
            assert list(fj) == fp.keys()
            for k in fj:
                a, b = fj[k][()], fp[k]
                assert (a.dtype, a.shape) == (b.dtype, b.shape)
                assert fj[k].compression_opts == 9
                if k == "semantics":
                    np.testing.assert_array_equal(b, a)
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        with h5py.File(os.path.join(ws.output_path, n), "r") as f:
            assert all(f[k].compression_opts == 9 for k in f)
    assert {"best.ckpt", "last.ckpt"} <= set(os.listdir(ws.model_path))
