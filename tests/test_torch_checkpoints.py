"""Checkpoints both ways between the packages: the port's msgpack codec
(``segfusion_tpu_torch.utils.checkpoints``, no Flax) against
``flax.serialization``; the module <-> Flax tree conversion; a
port-trained FusionNet fused by the JAX Pipeline; and ``train_fusion`` on
the CPU writing checkpoints that Flax, the JAX trainer's optax state and
the port's ``test_fusion`` read."""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from segfusion_tpu.config import load_config as j_load_config
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.core.volume import init_scene_volume as j_init_volume
from segfusion_tpu.utils import checkpoints as jck
from segfusion_tpu.utils.optim import get_optimizer as j_get_optimizer
from segfusion_tpu.utils.schedulers import get_schedule as j_get_schedule
from segfusion_tpu_torch import test_fusion as port_test_fusion
from segfusion_tpu_torch.config import Config, load_config
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.core.volume import init_scene_volume
from segfusion_tpu_torch.train_fusion import train_fusion
from segfusion_tpu_torch.utils import checkpoints as ck
from segfusion_tpu_torch.utils.convert import (fusionnet_from_checkpoint,
                                               fusionnet_from_flax, to_flax)
from tests.test_torch_nets import one_torch_thread  # noqa: F401
from tests.test_torch_pipeline import ORIGIN, RES, _frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_SMALL = os.path.join(ROOT, "configs", "fusion", "synthetic_small.yaml")
leaves = jax.tree_util.tree_leaves


def _tree(rng):
    """Every leaf kind a checkpoint holds."""
    return {
        "params": {"Conv_0": {"kernel": rng.randn(3, 3, 4, 5).astype(
            np.float32), "bias": np.zeros(5, np.float32)}},
        "opt_state": {"0": {}, "1": {"count": np.asarray(7, np.int32)}},
        "epoch": np.asarray(3), "best_iou": np.asarray(0.625),
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-9),
                    "u8": np.arange(200, dtype=np.uint8),
                    "mask": np.array([True, False])},
    }


# Python leaves: msgpack's own types (a checkpoint stores numpy arrays)
PY = {"int": 300, "neg": -40000, "float": 1.5, "str": "x" * 40,
      "none": None, "true": True, "list": [1, "a"]}


def _assert_same(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(leaves(a), leaves(b)):
        assert type(x) is type(y), (x, y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_port_writes_what_flax_reads(tmp_path):
    """The port's bytes are Flax's own, and Flax restores the tree."""
    tree = dict(_tree(np.random.RandomState(0)), py=PY)
    data = ck.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _assert_same(serialization.msgpack_restore(data),
                 serialization.msgpack_restore(
                     serialization.msgpack_serialize(tree)))
    path = str(tmp_path / "port.ckpt")
    ck.save_checkpoint({"params": tree["params"], "epoch": 2}, path)
    assert not os.path.exists(path + ".tmp")
    _assert_same(jck.load_checkpoint(path), ck.load_checkpoint(path))


def test_flax_writes_what_the_port_reads(tmp_path):
    tree = _tree(np.random.RandomState(1))
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(tree, path)
    _assert_same(ck.load_checkpoint(path), jck.load_checkpoint(path))
    data = serialization.msgpack_serialize({"py": PY})
    assert ck.msgpack_restore(data) == serialization.msgpack_restore(data)


@pytest.mark.parametrize("writer", ["port", "flax"])
def test_chunked_arrays_round_trip(monkeypatch, writer):
    """Arrays over the chunk size travel in Flax's chunked form (the
    chunk size cut to 256 bytes on both sides)."""
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    tree = {"big": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "small": np.ones(3, np.int32)}
    if writer == "port":
        data = ck.msgpack_serialize(tree)
        assert data == serialization.msgpack_serialize(tree)
        back = serialization.msgpack_restore(data)
    else:
        back = ck.msgpack_restore(serialization.msgpack_serialize(tree))
    _assert_same(back, tree)


def test_codec_refuses_what_it_does_not_know():
    """An unknown dtype name (bfloat16 here) or ext type raises."""
    data = serialization.msgpack_serialize(
        {"w": jnp.ones(3, jnp.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        ck.msgpack_restore(data)
    with pytest.raises(ValueError, match="ext type"):
        ck.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(TypeError):
        ck.msgpack_serialize({"t": object()})


def test_restore_into_and_surgery_match_jax(tmp_path):
    """restore_into checks keys and shapes; remove_parent, select_child
    and separate_pipeline give the JAX package's results."""
    template = {"a": np.zeros((2, 3)), "b": {"c": np.zeros(4)}}
    state = {"a": np.ones((2, 3)), "b": {"c": np.ones(4)}, "extra": 1}
    _assert_same(ck.restore_into(template, state),
                 {"a": np.ones((2, 3)), "b": {"c": np.ones(4)}})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_into(template, {"a": np.ones((3, 2)), "b": {"c": 0}})
    with pytest.raises(ValueError, match="lacks"):
        ck.restore_into(template, {"a": np.ones((2, 3))})
    flat = {"module.x": 1, "module.y.z": 2, "w": 3}
    nested = {"_fusion_network": {"p": 1}, "other": 2}
    for fn in ("remove_parent", "select_child"):
        for tree, key in ((flat, "module"), (nested, "_fusion_network")):
            assert getattr(ck, fn)(tree, key) == getattr(jck, fn)(tree, key)
    pipe_ckpt = str(tmp_path / "pipe.ckpt")
    jck.save_checkpoint({"params": {"fusion": {"k": np.ones(2)}},
                         "batch_stats": {"fusion": {"m": np.zeros(2)}},
                         "epoch": 4}, pipe_ckpt)
    ck.separate_pipeline(pipe_ckpt, str(tmp_path / "port.ckpt"))
    jck.separate_pipeline(pipe_ckpt, str(tmp_path / "jax.ckpt"))
    _assert_same(ck.load_checkpoint(str(tmp_path / "port.ckpt")),
                 jck.load_checkpoint(str(tmp_path / "jax.ckpt")))


def test_port_trained_net_fuses_the_same_in_jax(tmp_path):
    """A FusionNet trained by the port (one chunk, one update), saved by
    the port and loaded by the JAX Pipeline through its own
    ``load_checkpoint`` / ``restore_into``, fuses the same volume as the
    port: the trees round-trip bit-exact, the volumes within the f32
    slice bounds of tests/test_torch_pipeline.py."""
    jcfg = j_load_config(CFG_SMALL)
    jcfg.DATA.update(resx=32, resy=32, init_value=0.1)
    jcfg.SETTINGS.rows_impl = "xla"
    jpipe = JPipeline(jcfg)
    jparams, jstats = jpipe.init_fusion_params(jax.random.PRNGKey(0), 32, 32)
    cfg = Config(copy.deepcopy(jcfg))
    net = fusionnet_from_flax(jparams, jstats, cfg.FUSION_MODEL)
    pipe = Pipeline(cfg, fusion_net=net, device="cpu", train=True)
    frames = {k: torch.as_tensor(v[:, :32, :32] if v.ndim > 2 and
                                 k != "intrinsics" else v)
              for k, v in _frames(4).items() if k in (
                  "depth", "extrinsics", "intrinsics", "mask")}
    vol = init_scene_volume((64, 64, 64), ORIGIN, RES, 0.1, device="cpu")
    gt = torch.as_tensor(np.clip(np.random.RandomState(0).randn(64, 64, 64)
                                 * 0.05, -0.1, 0.1).astype(np.float32))
    from segfusion_tpu_torch.utils.optim import get_optimizer
    from segfusion_tpu_torch.utils.schedulers import get_schedule
    opt = get_optimizer(cfg.TRAINING.optimizer, pipe.fusion_net,
                        get_schedule(1e-3, None), clipping=True)
    pipe.train_sequence(vol, gt, frames, torch.zeros(4, dtype=torch.bool))
    opt.step()
    params, stats = to_flax(pipe.fusion_net)
    assert _max_diff(params, jparams) > 0      # the update moved them
    path = str(tmp_path / "trained.ckpt")
    ck.save_checkpoint({"params": params, "batch_stats": stats}, path)

    loaded = jck.load_checkpoint(path)
    jp = jck.restore_into(jparams, loaded["params"])
    js = jck.restore_into(jstats, loaded["batch_stats"])
    _assert_same(jax.tree_util.tree_map(np.asarray, jp), params)

    jvol = j_init_volume((64, 64, 64), ORIGIN, RES, 0.1)
    jout = jpipe.fuse_sequence((jp, js), jvol, {
        k: jnp.asarray(v.numpy()) for k, v in frames.items()}, None)
    out = Pipeline(cfg, fusion_net=fusionnet_from_checkpoint(
        path, cfg.FUSION_MODEL), device="cpu").fuse_sequence(
            init_scene_volume((64, 64, 64), ORIGIN, RES, 0.1, device="cpu"),
            frames)
    jw = np.asarray(jout.weights)
    np.testing.assert_allclose(out.weights.numpy(), jw, atol=1e-3, rtol=1e-3)
    obs = jw > 0.05
    assert obs.sum() > 1000
    np.testing.assert_allclose(out.tsdf.numpy()[obs],
                               np.asarray(jout.tsdf)[obs], atol=1e-3)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(leaves(a), leaves(b)))


def test_train_fusion_writes_checkpoints_flax_and_jax_read(tmp_path):
    """``train_fusion`` on synthetic_small (1 epoch, 10 frames of 48x48,
    chunks of 4, the last one padded) writes best.ckpt and last.ckpt;
    Flax reads both; last's optimizer state restores into the JAX
    trainer's optax state (rmsprop, clipping, poly_lr) with the update
    count; ``test_fusion`` loads best.ckpt into the net that trained."""
    cfg = load_config(CFG_SMALL)
    cfg.SETTINGS.experiment_path = str(tmp_path / "train")
    net, ws = train_fusion(cfg, device="cpu")
    best = os.path.join(ws.model_path, "best.ckpt")
    last = os.path.join(ws.model_path, "last.ckpt")
    for path in (best, last):
        with open(path, "rb") as f:
            state = serialization.msgpack_restore(f.read())
        assert int(state["epoch"]) == 1
        _assert_same(state["params"], to_flax(net)[0])
    last_state = jck.load_checkpoint(last)
    jcfg = j_load_config(CFG_SMALL)
    tx = optax.chain(optax.clip_by_global_norm(1.0), j_get_optimizer(
        jcfg.TRAINING.optimizer, learning_rate=j_get_schedule(
            1e-4, jcfg.TRAINING.scheduler)))
    opt_state = jck.restore_into(tx.init(last_state["params"]),
                                 last_state["opt_state"])
    assert int(opt_state[1][1][1].count) == 3       # 10 frames, chunks of 4
    assert set(last_state) == {"epoch", "params", "batch_stats",
                               "opt_state", "best_iou"}

    tcfg = load_config(CFG_SMALL)
    tcfg.SETTINGS.experiment_path = str(tmp_path / "test")
    tcfg.TESTING.fusion_model_path = best
    loaded = port_test_fusion.test_fusion(tcfg, device="cpu")
    tcfg.SETTINGS.experiment_path = str(tmp_path / "direct")
    tcfg.TESTING.fusion_model_path = None
    tcfg.TIMESTAMP = None
    assert port_test_fusion.test_fusion(tcfg, device="cpu",
                                        fusion_net=net) == loaded


def test_train_fusion_resumes_from_last_checkpoint(tmp_path):
    """TRAINING.resume: a second epoch starts from last.ckpt's parameters,
    running statistics and optimizer state (its update count goes on from
    3 to 6), as the JAX trainer resumes."""
    cfg = load_config(CFG_SMALL)
    cfg.SETTINGS.experiment_path = str(tmp_path / "first")
    _, ws = train_fusion(cfg, device="cpu")
    last = os.path.join(ws.model_path, "last.ckpt")
    first = ck.load_checkpoint(last)
    cfg2 = load_config(CFG_SMALL)
    cfg2.SETTINGS.experiment_path = str(tmp_path / "second")
    cfg2.TRAINING.update(resume=last, n_epochs=2)
    net, ws2 = train_fusion(cfg2, device="cpu")
    second = ck.load_checkpoint(os.path.join(ws2.model_path, "last.ckpt"))
    assert int(second["epoch"]) == 2
    assert int(second["opt_state"]["1"]["1"]["1"]["count"]) == 6
    assert _max_diff(second["params"], first["params"]) > 0
    _assert_same(second["params"], to_flax(net)[0])
