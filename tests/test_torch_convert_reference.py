"""Conversion of reference PyTorch checkpoints onto the port's modules
(``segfusion_tpu_torch/utils/torch_convert.py`` and the
``convert_checkpoint`` entry point) against the JAX package's converter.

The reference checkout is not in the repo, so the state dicts are
synthetic, with the names and order the JAX converter reads: FusionNet
layers in its execution order (``_ordered_flax_layers``; names are free,
the order decides), AdapNet++ under the reference names of
``adapnet_name_map``, plus reference entries the converters drop
(``num_batches_tracked``, ``eASPP*.branch5_bn``). The port's converted
module must equal ``utils/convert.py`` applied to the JAX converter's Flax
tree parameter for parameter, exactly, and so give the same forward.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segfusion_tpu.models.adapnet import AdapNet as JAdapNet
from segfusion_tpu.models.fusionnet import FusionNetV3 as JFusionNetV3
from segfusion_tpu.utils import torch_convert as jtc
from segfusion_tpu.utils.checkpoints import load_checkpoint as j_load
from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.convert_checkpoint import convert_checkpoint
from segfusion_tpu_torch.models.adapnet import build_adapnet
from segfusion_tpu_torch.models.fusionnet import build_fusion_net
from segfusion_tpu_torch.utils.convert import (adapnet_from_flax,
                                               fusionnet_from_flax)
from segfusion_tpu_torch.utils.torch_convert import (
    adapnet_name_map, convert_adapnet_state_dict,
    convert_fusionnet_state_dict, load_torch_checkpoint)
from tests.test_torch_fusionnet_v12 import _setup as v12_setup
from tests.test_torch_nets import (_fusion_inputs,  # noqa: F401
                                   one_torch_thread, random_variables)

H = W = 16


def _fusion_case(name, use_semantics):
    """(Flax params, stats template, port FUSION_MODEL, numpy inputs)."""
    if name == "v3":
        rng = np.random.RandomState(1)
        fmodel = JFusionNetV3(n_points=9, use_semantics=use_semantics,
                              growth_factor=3)
        data = _fusion_inputs(rng, 1, H, W, 9, use_semantics)
        params, stats = random_variables(
            fmodel, rng, {k: jnp.asarray(v) for k, v in data.items()})
        cfg = Config({"name": "v3", "n_points": 9,
                      "use_semantics": use_semantics, "output_scale": 1.0,
                      "growth_factor": 3})
        return params, stats, cfg, data
    _, data, params, stats, cfg, _ = v12_setup(name, use_semantics, H, W)
    return params, stats, cfg, data


def _reference_fusion_state(params, stats, cfg, rng):
    """A reference-ordered state dict: each Flax layer of the JAX
    converter's order as one torch module (OIHW kernels, BatchNorm with
    running statistics and num_batches_tracked), random values."""
    state = {}
    for i, (_, kind, entry, head) in enumerate(
            jtc._ordered_flax_layers(params, stats, dict(cfg))):
        def shape(a):
            return np.asarray(a).shape[1:] if head is not None \
                else np.asarray(a).shape
        if kind == "conv":
            kh, kw, cin, cout = shape(entry["kernel"])
            state[f"layer{i}.weight"] = rng.randn(cout, cin, kh, kw)
            if "bias" in entry:
                state[f"layer{i}.bias"] = rng.randn(cout) * 0.1
        else:
            (c,) = shape(entry["scale"])
            state[f"layer{i}.weight"] = rng.uniform(0.8, 1.2, c)
            state[f"layer{i}.bias"] = rng.randn(c) * 0.1
            state[f"layer{i}.running_mean"] = rng.randn(c) * 0.1
            state[f"layer{i}.running_var"] = rng.uniform(0.5, 1.5, c)
            state[f"layer{i}.num_batches_tracked"] = np.int64(7)
    return {k: np.asarray(v, np.float32) if np.ndim(v) else np.asarray(v)
            for k, v in state.items()}


def _assert_same_module(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("name,use_semantics", [
    ("v1", False), ("v1", True), ("v2", True), ("v3", True), ("v3", False),
    ("v3s", True)])
def test_fusionnet_conversion_matches_jax(name, use_semantics):
    """FusionNet v1 / v2 / v3 (and v3 with stacked heads): the port's
    conversion equals the JAX converter's tree loaded by
    ``utils/convert.py``, tensor for tensor, and infers the same."""
    params, stats, cfg, data = _fusion_case(name, use_semantics)
    state = _reference_fusion_state(params, stats, cfg,
                                    np.random.RandomState(2))
    j_params, j_stats = jtc.convert_fusionnet_state_dict(
        state, params, stats, dict(cfg))
    want = fusionnet_from_flax(j_params, j_stats, cfg).eval()
    got = build_fusion_net(cfg)
    got.load_state_dict(convert_fusionnet_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg))
    got.eval()
    _assert_same_module(got, want)
    inputs = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        assert torch.equal(got(inputs), want(inputs))


def test_fusionnet_conversion_refuses_mismatches():
    """Another growth factor (layer count), a wrong shape: raise."""
    params, stats, cfg, _ = _fusion_case("v3", True)
    state = {k: torch.from_numpy(v) for k, v in _reference_fusion_state(
        params, stats, cfg, np.random.RandomState(0)).items()}
    other = Config(dict(cfg, growth_factor=4))
    with pytest.raises(ValueError, match="layer count"):
        convert_fusionnet_state_dict(state, other)
    bad = dict(state)
    bad["layer0.weight"] = bad["layer0.weight"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_fusionnet_state_dict(bad, cfg)


def _reference_adapnet_state(params, stats, stage, rng):
    """A state dict under the reference names of ``adapnet_name_map``
    for every layer the Flax template has, plus the entries the
    converters drop."""
    flat = dict(jtc._flatten_flax(params))
    flat_s = dict(jtc._flatten_flax(stats))
    state = {}
    for tname, (fpath, kind) in jtc.adapnet_name_map(stage).items():
        if kind in ("conv", "convT"):
            k = flat.get(fpath + ("kernel",))
            if k is None:
                continue
            kh, kw, a, b = np.asarray(k).shape
            state[f"{tname}.weight"] = rng.randn(
                *((a, b, kh, kw) if kind == "convT" else (b, a, kh, kw))
            ) / np.sqrt(a * kh * kw)
            if fpath + ("bias",) in flat:
                state[f"{tname}.bias"] = rng.randn(
                    np.asarray(flat[fpath + ("bias",)]).shape[0]) * 0.1
        else:
            if fpath + ("mean",) not in flat_s:
                continue
            c = np.asarray(flat_s[fpath + ("mean",)]).shape[0]
            state[f"{tname}.weight"] = rng.uniform(0.8, 1.2, c)
            state[f"{tname}.bias"] = rng.randn(c) * 0.1
            state[f"{tname}.running_mean"] = rng.randn(c) * 0.1
            state[f"{tname}.running_var"] = rng.uniform(0.5, 1.5, c)
            state[f"{tname}.num_batches_tracked"] = np.int64(3)
    prefix = "eASPP" if stage == 1 else "eASPP_mod1"
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        state[f"{prefix}.branch5_bn.{leaf}"] = np.ones(256)
    return {k: np.asarray(v, np.float32) if np.ndim(v) else np.asarray(v)
            for k, v in state.items()}


@pytest.mark.parametrize("stage", [1, 2])
def test_adapnet_conversion_matches_jax(stage):
    """AdapNet++ stages 1 and 2 at ResNet-50 widths: the port's
    conversion (``adapnet_name_map``) equals the JAX converter's tree
    loaded by ``utils/convert.py``, tensor for tensor, and gives the same
    logits on a 32x32 frame."""
    rng = np.random.RandomState(stage)
    x = jnp.zeros((1, 32, 32, 3))
    model = JAdapNet(n_classes=8, stage=stage)
    params, stats = random_variables(model, rng,
                                     *((x,) if stage == 1 else (x, x)))
    state = _reference_adapnet_state(params, stats, stage, rng)
    j_params, j_stats = jtc.convert_adapnet_state_dict(state, params, stats,
                                                       stage)
    cfg = Config({"n_classes": 8, "stage": stage})
    want = adapnet_from_flax(j_params, j_stats, cfg).eval()
    got = build_adapnet(cfg)
    got.load_state_dict(convert_adapnet_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, stage, 8))
    got.eval()
    _assert_same_module(got, want)
    assert set(adapnet_name_map(stage)) == set(jtc.adapnet_name_map(stage))
    img = torch.from_numpy(rng.uniform(0, 1, (1, 3, 32, 32)).astype(
        np.float32))
    with torch.no_grad():
        args = (img,) if stage == 1 else (img, img)
        assert torch.equal(got.logits(*args), want.logits(*args))
    short = {k: torch.from_numpy(v) for k, v in state.items()
             if not k.startswith("decoder.aux_conv1.")}
    with pytest.raises(KeyError, match="without a checkpoint source"):
        convert_adapnet_state_dict(short, stage, 8)


def test_convert_checkpoint_entry_point(tmp_path):
    """``python -m segfusion_tpu_torch.convert_checkpoint --type fusion``
    on a ``.pth.tar`` (``model_state`` under a ``module.`` prefix): the
    written checkpoint is the JAX converter's tree, read by the JAX
    package's own loader."""
    params, stats, cfg, _ = _fusion_case("v3", True)
    state = _reference_fusion_state(params, stats, cfg,
                                    np.random.RandomState(5))
    src = tmp_path / "best.pth.tar"
    torch.save({"model_state": {f"module.{k}": torch.from_numpy(v)
                                for k, v in state.items()}, "epoch": 9},
               src)
    assert load_torch_checkpoint(str(src)).keys() == {
        f"module.{k}" for k in state}
    yml = tmp_path / "fusion.yaml"
    yml.write_text("FUSION_MODEL:\n  name: v3\n  n_points: 9\n"
                   "  growth_factor: 3\n  use_semantics: true\n"
                   "  output_scale: 1.0\n")
    out = tmp_path / "fusion_best.ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "segfusion_tpu_torch.convert_checkpoint",
         "--type", "fusion", "--config", str(yml), "--in", str(src),
         "--out", str(out), "--strip-prefix", "module"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    j_params, j_stats = jtc.convert_fusionnet_state_dict(
        state, params, stats, dict(cfg))
    ck = j_load(str(out))
    assert int(ck["epoch"]) == 0
    for key, tree in (("params", j_params), ("batch_stats", j_stats)):
        flat = dict(jtc._flatten_flax(tree))
        got = dict(jtc._flatten_flax(ck[key]))
        assert flat.keys() == got.keys()
        for k in flat:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(flat[k]))
    with pytest.raises(ValueError, match="FUSION_MODEL"):
        convert_checkpoint("fusion", str(src), str(out))
