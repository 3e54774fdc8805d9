"""The nets are found by name, one file an architecture: both
configurations resolve and draw the parent's weights to the bit, a new
segmenter comes in as a file of its own, and an unknown name stops a run
before anything is built."""

import copy
import hashlib
import shutil
import textwrap
import types

import pytest
import torch
from torch import nn

from gpubench import architectures, check, harness, weights
from gpubench.reference import fusion as rf
from gpubench.reference.layers import Attention, Linear, set_quantiser
from gpubench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345
# sha256 (first 16 hex digits) of each state dict the parent drew at SEED
# on the CPU, and its FLOPs a frame: a net file changes neither
PARENT = {
    "accuracy.stream": {"fusion": "a11cbe70231af5cf",
                        "segmenter": "eff6bcfa7341c793",
                        "flops": 117_073_114_656},
    "speed.stream": {"fusion": "31114819e100ed79", "flops": 10_711_124_752},
}


def _digest(state):
    h = hashlib.sha256()
    for k in sorted(state):
        v = state[k]
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(PARENT))
def test_configurations_resolve_to_the_parents_weights_and_flops(name):
    cell = harness.load_cell(name)
    c, cfg = cell.config["config"], harness.port_config(cell.config)
    want = PARENT[name]
    with torch.device("meta"):
        fnet = architectures.fusion(c).port(cfg.FUSION_MODEL)
    got = {"fusion": _digest(weights.random_state(
        fnet, weights.generator(SEED, 1, "cpu"), "cpu"))}
    if "segmenter" in want:
        with torch.device("meta"):
            snet = architectures.segmenter(c).port(cfg.SEMANTIC_2D_MODEL)
        got["segmenter"] = _digest(weights.random_state(
            snet, weights.generator(SEED, 2, "cpu"), "cpu", torch.bfloat16))
    run = types.SimpleNamespace(
        cell=cell, seg_state={} if "segmenter" in want else None)
    got["flops"] = check.flops_per_frame(run)
    assert got == want


TOY = '''
"""A toy segmenter: a linear layer, LayerNorm, one attention product and
a linear head; the "port" is the reference itself."""

import math

import torch
from torch import nn

from gpubench.reference.layers import Attention, Linear

WIDTH = 64


class Toy(nn.Module):
    def __init__(self, n_classes):
        super().__init__()
        self.proj_in = Linear(3, WIDTH)
        self.norm = nn.LayerNorm(WIDTH)
        self.attn = Attention()
        self.proj_out = Linear(WIDTH, n_classes)

    def forward(self, images, depths):
        b, h, w, _ = images.shape
        t = self.norm(self.proj_in(images.float().reshape(b, h * w, 3)
                                   / 255.0))
        t = self.attn(t, t, t, 1.0 / math.sqrt(WIDTH))
        return self.proj_out(t).reshape(b, h, w, -1)


class Adapter:
    def __init__(self, net):
        self.net = net

    @torch.no_grad()
    def apply_fn_batched(self, images, depths):
        return self.net(images, depths)


def port(section):
    return Toy(int(section["n_classes"]))


def pipeline_segmenter(net):
    return Adapter(net)


def reference(section):
    return Toy(int(section["n_classes"]))
'''


@pytest.fixture
def toy_nets(tmp_path, monkeypatch):
    """A search path holding the fusion nets and the toy segmenter."""
    shutil.copytree(architectures.NETS / "fusion", tmp_path / "fusion")
    (tmp_path / "segmenter").mkdir()
    (tmp_path / "segmenter" / "toy.py").write_text(textwrap.dedent(TOY))
    monkeypatch.setattr(architectures, "NETS", tmp_path)
    return tmp_path


def _toy_cell():
    cell = tiny_cell("accuracy.stream")
    conf = copy.deepcopy(cell.config)
    conf["config"]["FUSION_MODEL"]["compute_dtype"] = "float32"
    conf["config"]["SEMANTIC_2D_MODEL"].update(name="toy",
                                               compute_dtype="float32")
    return harness.Cell(cell.entry, cell.bench, conf, cell.traffic, None)


def test_new_segmenter_is_a_file_of_its_own(toy_nets):
    cell = _toy_cell()
    run = harness.build(cell, SEED, "cpu")
    assert type(run.pipe.segmenter).__name__ == "Adapter"

    # the Linear kernels are drawn (variance 1 / fan_in), LayerNorm is 1, 0
    w = run.seg_state["proj_out.weight"]
    assert abs(float(w.var()) * w.shape[1] - 1.0) < 0.15
    assert torch.equal(run.seg_state["norm.weight"], torch.ones(64))
    assert torch.equal(run.seg_state["norm.bias"], torch.zeros(64))

    # the toy's Linear and matmul FLOPs join the frame's count
    n, c = 32 * 32, 30
    toy = 2 * n * (3 * 64 + 64 * n + n * 64 + 64 * c)
    labels = check.flops_per_frame(run)
    plain = check.flops_per_frame(types.SimpleNamespace(cell=cell,
                                                        seg_state=None))
    assert labels - plain == toy

    # the bf16 probe reaches the Linear layers and attention's products
    seg = architectures.segmenter(cell.config["config"]).reference(
        cell.config["config"]["SEMANTIC_2D_MODEL"])
    seg.load_state_dict(run.seg_state)
    img, dep = run.orbit["image"][:2], run.orbit["depth_input"][:2]
    with torch.no_grad():
        plain_out = seg(img, dep)
        set_quantiser(seg, rf.bf16_round)
        low = seg(img, dep)
    assert all(m.quantiser is rf.bf16_round for m in seg.modules()
               if isinstance(m, (Linear, Attention)))
    assert not torch.equal(plain_out, low)

    # the port's stream, labelled by the toy, against the reference's
    # replay through the toy's reference
    harness.run_window(run, 0.0, limit_units=2)
    final = run.pipe._exit_rows(run.layout, run.stream.rv)
    numbers = check.compare_run(run, final)
    assert numbers["weight_gap"] < 1e-5
    assert numbers["tsdf_gap"] < 1e-4
    assert numbers["label_mismatch"] == 0.0
    assert numbers["score_gap"] < 1e-6


@pytest.mark.parametrize("section, name, path", [
    ("FUSION_MODEL", "v9", "gpubench/nets/fusion/v9.py"),
    ("SEMANTIC_2D_MODEL", "segformer",
     "gpubench/nets/segmenter/segformer.py"),
    ("FUSION_MODEL", "../fusion/v3", "gpubench/nets/fusion/../fusion/v3.py"),
])
def test_unknown_name_stops_before_building(section, name, path,
                                            monkeypatch):
    cell = tiny_cell("accuracy.stream")
    conf = copy.deepcopy(cell.config)
    conf["config"][section]["name"] = name
    cell = harness.Cell(cell.entry, cell.bench, conf, cell.traffic, None)

    def built(*args, **kwargs):
        raise AssertionError("a net was built")

    monkeypatch.setattr(weights, "random_state", built)
    with pytest.raises(SystemExit, match=f"add {path}$"):
        harness.build(cell, SEED, "cpu")
    with pytest.raises(SystemExit, match=f"{section}.name {name!r}"):
        check.reference_nets(conf, {}, {}, "cpu")


def test_segmenter_name_defaults_to_adapnet():
    conf = harness.load_cell("accuracy.stream").config["config"]
    assert "name" not in conf["SEMANTIC_2D_MODEL"]
    mod = architectures.segmenter(conf)
    assert mod.__file__ == str(architectures.NETS / "segmenter"
                               / "adapnet.py")


def test_weights_raise_on_a_parameter_without_a_rule():
    net = nn.Sequential(nn.Linear(4, 4), nn.Embedding(5, 4))
    with pytest.raises(ValueError, match="1.weight of a Embedding"):
        weights.random_state(net, weights.generator(1, 1, "cpu"), "cpu")


def test_weights_draw_linear_kernels_and_fill_norms():
    net = nn.Sequential(nn.Conv2d(3, 8, 3), nn.Linear(256, 64),
                        nn.GroupNorm(4, 64), nn.LayerNorm(64))
    state = weights.random_state(net, weights.generator(2, 1, "cpu"), "cpu")
    assert list(state) == list(net.state_dict())
    for key, fan_in in (("0.weight", 27), ("1.weight", 256)):
        assert abs(float(state[key].var()) * fan_in - 1.0) < 0.15, key
    for key in ("0.bias", "1.bias", "2.bias", "3.bias"):
        assert not state[key].any(), key
    for key in ("2.weight", "3.weight"):
        assert torch.equal(state[key], torch.ones(64)), key
