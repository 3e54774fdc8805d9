"""The port's multi-process path (``parallel/multihost.py`` and its worker
``parallel/multihost_worker.py``): two OS processes on localhost joined by
``torch.distributed`` over gloo, each with its own timeout. The scene
shards are disjoint and cover all scenes; each local sum is the worker's
fusion of its scenes run here in one process; the all-reduced total is
the same on both and equals the sum of the locals. The worker's
per-scene fusion is held to the JAX package's ``fuse_sequence`` on the
worker's inputs from the same Flax weights (tests/test_rowvol.py's row
bounds: num and w within atol 1e-4 + rtol 1e-4). Without the flag nothing
starts."""

import copy
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.config import Config as JConfig
from segfusion_tpu.core.pipeline import Pipeline as JPipeline
from segfusion_tpu.core.volume import init_scene_volume as jinit_volume
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.parallel import multihost
from segfusion_tpu_torch.parallel import multihost_worker as worker
from segfusion_tpu_torch.utils.convert import fusionnet_from_flax
from tests.test_torch_nets import one_torch_thread  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_shard_scenes_and_all_reduce():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "segfusion_tpu_torch.parallel.multihost_worker",
         str(i), "2", str(port), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    recs = [json.loads([ln for ln in out.splitlines()
                        if "MULTIHOST_OK" in ln][-1]) for out in outs]
    assert sorted(r["process"] for r in recs) == [0, 1]
    for r in recs:
        assert r["processes"] == 2 and r["backend"] == "gloo"
        assert r["multihost"] is True
    s0, s1 = set(recs[0]["scenes"]), set(recs[1]["scenes"])
    assert not (s0 & s1) and s0 | s1 == set(worker.SCENES)
    pipe = Pipeline(worker.worker_config(), device="cpu")
    total = 0.0
    for r in recs:
        local = worker.fuse_scenes(pipe, [worker.SCENES.index(s)
                                          for s in r["scenes"]])
        assert r["local_sum"] == pytest.approx(local, rel=1e-6)
        assert local > 0
        total += r["local_sum"]
    assert recs[0]["global_sum"] == recs[1]["global_sum"]
    assert recs[0]["global_sum"] == pytest.approx(total, rel=1e-12)


def test_worker_fusion_matches_jax():
    """Each scene's stream through the port's ``fuse_sequence`` (as the
    worker runs it) and the JAX package's, from one Flax tree."""
    pcfg = worker.worker_config()
    jcfg = JConfig(copy.deepcopy(dict(pcfg)))
    jpipe = JPipeline(jcfg)
    params, stats = jpipe.init_fusion_params(jax.random.PRNGKey(0),
                                             worker.H, worker.W)
    pipe = Pipeline(Config(copy.deepcopy(dict(pcfg))),
                    fusion_net=fusionnet_from_flax(params, stats,
                                                   pcfg.FUSION_MODEL),
                    device="cpu")
    for i in range(len(worker.SCENES)):
        frames = worker.scene_frames(i)
        jv = jpipe.fuse_sequence(
            (params, stats),
            jinit_volume((16, 16, 16), np.full(3, -0.8, np.float32), 0.1,
                         0.1),
            {k: jnp.asarray(v) for k, v in frames.items()}, None)
        v = pipe.fuse_sequence(worker.scene_volume("cpu"), {
            k: torch.as_tensor(x) for k, x in frames.items()})
        assert float(v.weights.sum()) > 0
        for a, b in ((v.weights, jv.weights), (v.num, jv.num)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=1e-4, rtol=1e-4)


def test_off_without_the_flag():
    cfg = worker.worker_config()
    assert multihost.initialize(cfg) is False
    assert multihost.initialize() is False
    assert not multihost.is_multihost()
    assert multihost.local_scene_shard(worker.SCENES) == worker.SCENES
    cfg.SETTINGS.multihost = True
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(cfg)
