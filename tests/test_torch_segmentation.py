"""The port's segmentation path against the JAX package's, on the CPU:
``RunningScore``, ``PrefetchLoader``'s seed and ``drop_last``, the
ResNet-50 import, the PNG strips, the config's segmentation keys, and
``train_segmentation`` / ``test_segmentation`` against the JAX CLIs on
configs/segmentation/synthetic_small.yaml (stage 1, 2 epochs of 3 steps,
32x32), both started from one Flax checkpoint (``pretrained``), the
layer3 dropout off (the two random streams differ).

The port's run reads the JAX package's Synthetic dataset, as
tests/test_torch_test_fusion.py does (the two ray marchers may pick
neighbouring voxels on ~1% of pixels). The first step's three head
losses agree to f32 rounding (both within 3e-4 of a float64 evaluation,
which the two packages give alike to 1e-6;
tests/test_torch_adapnet.py holds the model so); after that the f32
trajectories part at the rate of the random net's conditioning (its f32
gradients lie 13-16% of the largest off float64 in either package) under
SGD at lr 0.01: per-epoch losses within rtol 3e-2 (measured 6e-3),
validation metrics within 0.05 (measured up to 0.023). Checkpoints are
held exactly: each package's load into the other and give its logits.
"""

import os
import struct
import types
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segfusion_tpu.config import load_config as j_load_config
from segfusion_tpu.data.prefetch import PrefetchLoader as JLoader
from segfusion_tpu.data.synthetic import Synthetic as JSynthetic
from segfusion_tpu.models.adapnet import AdapNet as JAdapNet
from segfusion_tpu.utils import checkpoints as jck
from segfusion_tpu.utils import workspace as j_workspace
from segfusion_tpu.utils.metrics import RunningScore as JRunningScore
from segfusion_tpu.utils.optim import get_optimizer as j_get_optimizer
from segfusion_tpu.utils.schedulers import get_schedule as j_get_schedule
from segfusion_tpu.utils.torch_convert import (
    convert_resnet50_encoder as j_convert_resnet50)
from segfusion_tpu_torch import test_segmentation as port_test_seg
from segfusion_tpu_torch import train_segmentation as port_train_seg
from segfusion_tpu_torch.config import Config, load_config
from segfusion_tpu_torch.data import PrefetchLoader
from segfusion_tpu_torch.utils.convert import adapnet_from_flax, to_flax
from segfusion_tpu_torch.utils.metrics import RunningScore, runningScore
from segfusion_tpu_torch.utils.png import write_png
from segfusion_tpu_torch.utils.torch_import import (
    convert_resnet50_encoder, load_torch_checkpoint)
from tests.test_torch_nets import (one_torch_thread,  # noqa: F401
                                   random_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SMALL = os.path.join(ROOT, "configs", "segmentation",
                         "synthetic_small.yaml")
leaves = jax.tree_util.tree_leaves


# -- RunningScore, PrefetchLoader --------------------------------------------

@pytest.mark.parametrize("ignore_index", [0, -100])
@pytest.mark.parametrize("absent", [False, True])
def test_running_score_matches_jax(ignore_index, absent):
    """Three updates of 2 label / prediction images over 6 classes (labels
    out of range, -1 and 6, are left out): the metrics and per-class IoU
    equal JAX's, NaN where a class is absent from both."""
    rng = np.random.RandomState(abs(ignore_index) + absent)
    js, ps = JRunningScore(6, ignore_index), RunningScore(6, ignore_index)
    for _ in range(3):
        lt = rng.randint(-1, 7, (2, 8, 9))
        lp = rng.randint(0, 6, (2, 8, 9))
        if absent:
            lt[lt == 4], lp[lp == 4] = 5, 5
        js.update(lt, lp)
        ps.update(lt, lp)
    want, got = js.get_scores(), ps.get_scores()
    np.testing.assert_equal(got, want)
    assert np.isnan(got[1][4]) == absent
    assert runningScore is RunningScore
    ps.reset()
    assert ps.confusion_matrix.sum() == 0


class _Frames:
    """Seven frame dicts of arrays, numbers and ids."""

    def __init__(self):
        rng = np.random.RandomState(11)
        self.items = [{"depth": rng.rand(3, 4).astype(np.float32),
                       "index": i, "frame_id": f"scene/{i}"}
                      for i in range(7)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("batch_size,seed,drop_last,num_workers", [
    (2, 1911, True, 0), (3, 5, True, 2), (2, 1911, False, 2),
    (1, 7, True, 0)])
def test_prefetch_loader_seed_and_drop_last_match_jax(batch_size, seed,
                                                      drop_last,
                                                      num_workers):
    """Shuffled with ``RandomState(seed + pass)`` and a short last batch
    dropped or kept: the same batches in the same order over three passes,
    and the same length, as JAX's loader."""
    kw = dict(batch_size=batch_size, shuffle=True, num_workers=num_workers,
              seed=seed, drop_last=drop_last)
    jl, pl = JLoader(_Frames(), **kw), PrefetchLoader(_Frames(), **kw)
    assert len(pl) == len(jl)
    for _ in range(3):
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(jl)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]))


# -- the ResNet-50 import ----------------------------------------------------

def _torchvision_state(seed):
    """A torchvision-keyed resnet50 state dict with random values (BN
    statistics too)."""
    import fake_torchvision
    torch.manual_seed(seed)
    net = fake_torchvision.ResNet50()
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.rand_like(t) + 0.5 if "var" in name
                        else torch.randn_like(t) * 0.1)
    return net.state_dict()


@pytest.mark.parametrize("stage", [1, 2])
def test_convert_resnet50_encoder_matches_jax(stage, tmp_path):
    """A torchvision state dict (read back through ``torch.load`` with
    ``weights_only``) into the encoder(s) of a stage-1 / stage-2 model:
    every parameter and statistic equal to the JAX converter's result,
    the same count of arrays, the layers the surgery drops untouched."""
    rng = np.random.RandomState(stage)
    model = JAdapNet(n_classes=5, stage=stage)
    params, stats = random_variables(model, rng,
                                     *[jnp.zeros((1, 32, 32, 3))] * stage)
    path = str(tmp_path / "resnet50.pth")
    torch.save({"model_state": _torchvision_state(stage)}, path)
    state = load_torch_checkpoint(path)
    encoders = ("encoder_mod1", "encoder_mod2")[:stage]
    jp, js, j_n = j_convert_resnet50(
        {k: v.numpy() for k, v in state.items()}, params, stats, encoders)

    cfg = Config({"n_classes": 5, "stage": stage})
    net = adapnet_from_flax(params, stats, cfg)
    n = convert_resnet50_encoder(state, net, encoders)
    assert n == j_n > 0
    got_p, got_s = to_flax(net)
    for got, want in ((got_p, jp), (got_s, js)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(leaves(got), leaves(want)):
            np.testing.assert_array_equal(g, w)
    # the stem is not imported (the reference re-creates it)
    np.testing.assert_array_equal(got_p["encoder_mod1"]["Conv_0"]["kernel"],
                                  params["encoder_mod1"]["Conv_0"]["kernel"])
    with pytest.raises(KeyError, match="resnet50"):
        convert_resnet50_encoder({}, net, encoders)


# -- PNG, config -------------------------------------------------------------

def _read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows are all filter 0."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_round_trips(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(_read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_config_derives_the_segmentation_keys():
    """The reference's SEMANTIC_MODEL section reads as SEMANTIC_2D_MODEL,
    DATA.target_key comes from DATA.target_seg (else semantic_gt), and
    the keys the CLIs read have JAX's defaults."""
    multi = load_config(os.path.join(ROOT, "configs", "segmentation",
                                     "replica_multi.yaml"))
    want = j_load_config(os.path.join(ROOT, "configs", "segmentation",
                                      "replica_multi.yaml"))
    assert multi.SEMANTIC_2D_MODEL == dict(want.SEMANTIC_2D_MODEL)
    assert multi.SEMANTIC_2D_MODEL.stage == 2
    assert multi.DATA.target_key == "semantic_gt"
    small = load_config(CFG_SMALL)
    assert small.DATA.target_key == small.DATA.target_seg == "semantic_gt"
    assert small.TESTING.n_visualizations == 2
    assert multi.TESTING.n_visualizations == 10
    assert multi.TESTING.output_benchmark is False
    assert multi.TRAINING.optimization.random_mask is False
    assert multi.TRAINING.optimization.mask_prob == 0.25


# -- the trainer and the evaluation against the JAX CLIs ---------------------

def _configs(load, path, pretrained):
    cfg = load(CFG_SMALL)
    cfg.SETTINGS.experiment_path = path
    cfg.SEMANTIC_2D_MODEL.update(resn50_dropout=False, pretrained=pretrained)
    cfg.TRAINING.n_epochs = 2
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX trainer and the port's from one Flax checkpoint: their
    configs, the JAX trainer's scalars, the port's history and model."""
    import train_segmentation as jax_train_seg

    tmp = tmp_path_factory.mktemp("segmentation")
    params, stats = random_variables(
        JAdapNet(n_classes=4, stage=1, resn50_dropout=False),
        np.random.RandomState(0), jnp.zeros((1, 32, 32, 3)))
    pre = str(tmp / "pretrained.ckpt")
    jck.save_checkpoint({"params": params, "batch_stats": stats}, pre)
    scalars = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_workspace.Workspace, "add_scalar",
                   lambda self, tag, value, step=0:
                   scalars.append((tag, float(value))))
        jcfg = _configs(j_load_config, str(tmp / "jax"), pre)
        jcfg.DATA.target_key = "semantic_gt"
        jax_train_seg.train({}, jcfg)
        mp.setattr(port_train_seg, "get_data",
                   lambda name, data_cfg, device: JSynthetic(data_cfg))
        pcfg = _configs(load_config, str(tmp / "port"), pre)
        model, ws, history = port_train_seg.train_segmentation(pcfg, "cpu")
    jax_model = os.path.join(jcfg.SETTINGS.experiment_path, jcfg.TIMESTAMP,
                             "model")
    return types.SimpleNamespace(
        tmp=tmp, jcfg=jcfg, scalars=scalars, model=model,
        port_model=ws.model_path, jax_model=jax_model, history=history)


def test_train_segmentation_matches_jax(trained):
    """Per-epoch training losses and validation metrics of the two
    trainers (the tolerances of the module docstring)."""
    j_loss = [v for t, v in trained.scalars if t == "Train/loss_t"]
    h = trained.history
    assert len(j_loss) == len(h["train_loss"]) == 2
    assert h["steps"] == [3, 3]                 # 6 frames, batch 2
    np.testing.assert_allclose(h["train_loss"], j_loss, rtol=3e-2)
    assert h["train_loss"][1] < h["train_loss"][0]          # it learns
    for k in ("Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        want = [v for t, v in trained.scalars
                if t == f"Val/{k.replace(' ', '_')}"]
        got = [m[k] for m in h["val"]]
        np.testing.assert_allclose(got, want, atol=0.05)
    assert sorted(os.listdir(trained.port_model)) == \
        sorted(os.listdir(trained.jax_model)) == ["best.ckpt", "last.ckpt"]


def _jax_logits(path, x):
    ck = jck.load_checkpoint(path)
    return np.asarray(JAdapNet(n_classes=4, stage=1).apply(
        {"params": ck["params"], "batch_stats": ck["batch_stats"]},
        jnp.asarray(x), train=False)[0])


def _port_logits(path, x):
    net = port_train_seg.new_adapnet(Config({"n_classes": 4, "stage": 1}), 0)
    port_train_seg.load_weights(net, path)
    with torch.no_grad():
        out = net.eval().logits(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def test_checkpoints_load_in_the_other_package(trained):
    """Each trainer's best.ckpt and last.ckpt, read by the other package,
    give the logits the writer's own package gives, within 1e-5 of the
    largest (measured 4e-6: six SGD steps at lr 0.01 leave the running
    statistics far from the batch's, and the logits reach ~4e7 at
    inference); last.ckpt's keys are the same and the
    port's optimizer state restores into the JAX trainer's optax state
    (SGD with momentum after weight decay, poly_lr) with its 6 updates."""
    x = np.random.RandomState(3).uniform(0.5, 4, (2, 32, 32, 3)).astype(
        np.float32)
    for d in (trained.port_model, trained.jax_model):
        for name in ("best.ckpt", "last.ckpt"):
            path = os.path.join(d, name)
            want = _jax_logits(path, x)
            np.testing.assert_allclose(_port_logits(path, x), want,
                                       atol=1e-5 * np.abs(want).max(),
                                       rtol=0)
    port_last = jck.load_checkpoint(os.path.join(trained.port_model,
                                                 "last.ckpt"))
    jax_last = jck.load_checkpoint(os.path.join(trained.jax_model,
                                                "last.ckpt"))
    assert set(port_last) == set(jax_last) == {
        "epoch", "params", "batch_stats", "opt_state", "best_miou"}
    assert int(port_last["epoch"]) == int(jax_last["epoch"]) == 2
    opt = trained.jcfg.TRAINING.optimizer
    tx = j_get_optimizer(opt, learning_rate=j_get_schedule(
        float(opt.lr), trained.jcfg.TRAINING.scheduler))
    state = jck.restore_into(tx.init(port_last["params"]),
                             port_last["opt_state"])
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure(tx.init(jax_last["params"]))
    assert int(state[1][1].count) == 6          # 2 epochs of 3 steps
    # the port's model is its best or last checkpoint's, as trained
    np.testing.assert_array_equal(
        to_flax(trained.model)[0]["decoder"]["Conv_0"]["kernel"],
        port_last["params"]["decoder"]["Conv_0"]["kernel"])


def test_test_segmentation_matches_jax(trained, tmp_path, monkeypatch):
    """The evaluation CLI on the JAX trainer's best.ckpt: metrics equal
    to the JAX ``test`` (the same weights: logits within ~1e-6, so the
    argmax agrees; within 1e-9), and the input | depth | gt | estimate
    strips written, 32 x 128 pixels each."""
    import test_segmentation as jax_test_seg

    ckpt = os.path.join(trained.jax_model, "best.ckpt")
    jcfg = j_load_config(CFG_SMALL)
    jcfg.SETTINGS.experiment_path = str(tmp_path / "jax")
    jcfg.TESTING.semantic_2d_model_path = ckpt
    want = jax_test_seg.test(jcfg)

    monkeypatch.setattr(port_test_seg, "get_data",
                        lambda name, data_cfg, device: JSynthetic(data_cfg))
    cfg = load_config(CFG_SMALL)
    cfg.SETTINGS.experiment_path = str(tmp_path / "port")
    cfg.TESTING.semantic_2d_model_path = ckpt
    got = port_test_seg.test_segmentation(cfg, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    vis = os.path.join(cfg.SETTINGS.experiment_path, cfg.TIMESTAMP,
                       "output", "vis")
    assert sorted(os.listdir(vis)) == ["0000.png", "0001.png"]
    assert _read_png(os.path.join(vis, "0000.png")).shape == (32, 128, 3)
