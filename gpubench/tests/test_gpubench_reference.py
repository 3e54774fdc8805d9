"""The plain reference against the port on the CPU at a tiny size: the
nets on the same weights, and a whole stream of the row path with float32
nets against the reference's replay of the same frames."""

import copy

import pytest
import torch

from gpubench import architectures, check, harness, weights
from gpubench.tests.tiny import tiny_cell

CONFIG = harness.load_cell("accuracy.stream").config["config"]


def _port_fusion(use_semantics):
    from segfusion_tpu_torch.models.fusionnet import FusionNetV3
    return FusionNetV3(use_semantics=use_semantics)


@pytest.mark.parametrize("use_semantics", [False, True])
def test_fusionnet(use_semantics):
    port = _port_fusion(use_semantics).eval()
    ref = architectures.fusion(CONFIG).FusionNetV3(
        use_semantics=use_semantics).eval()
    assert set(port.state_dict()) == set(ref.state_dict())
    state = weights.random_state(ref, weights.generator(3, 1, "cpu"), "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    g = torch.Generator().manual_seed(0)
    x = {"tsdf_values": torch.rand(2, 16, 24, 9, generator=g) * 0.2 - 0.1,
         "tsdf_weights": torch.rand(2, 16, 24, 9, generator=g) * 5,
         "tsdf_frame": torch.rand(2, 16, 24, 1, generator=g) * 3,
         "semantic_frame": torch.rand(2, 16, 24, 1, generator=g)}
    with torch.no_grad():
        want = port(x).reshape(2, 16 * 24, 9)
        got = ref(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_adapnet_stage2():
    from segfusion_tpu_torch.models.adapnet import AdapNet, SegmenterAdapter
    port = AdapNet(n_classes=30, stage=2).eval()
    ref = architectures.segmenter(CONFIG).reference(
        CONFIG["SEMANTIC_2D_MODEL"]).eval()
    assert set(port.state_dict()) == set(ref.state_dict())
    state = weights.random_state(ref, weights.generator(4, 2, "cpu"), "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    g = torch.Generator().manual_seed(1)
    img = torch.rand(2, 32, 32, 3, generator=g) * 255
    dep = torch.rand(2, 32, 32, generator=g) * 4
    with torch.no_grad():
        want = SegmenterAdapter(port).apply_fn_batched(img, dep)
        got = ref(img, dep)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["accuracy.stream", "speed.stream"])
def test_stream_against_replay(name):
    """The port's row path (K1 carry, f16packed gathers) with float32 nets
    on 2 chunks against the reference's replay: summation order apart,
    the same volume."""
    cell = tiny_cell(name)
    conf = copy.deepcopy(cell.config)
    conf["config"]["FUSION_MODEL"]["compute_dtype"] = "float32"
    conf["config"]["SEMANTIC_2D_MODEL"]["compute_dtype"] = "float32"
    cell = harness.Cell(cell.entry, cell.bench, conf, cell.traffic, None)
    run = harness.build(cell, 2 ** 31 + 99, "cpu")
    harness.run_window(run, 0.0, limit_units=2)
    final = run.pipe._exit_rows(run.layout, run.stream.rv)
    numbers = check.compare_run(run, final)
    assert numbers["weight_gap"] < 1e-5
    assert numbers["tsdf_gap"] < 1e-4
    if name.startswith("accuracy"):
        assert numbers["label_mismatch"] == 0.0
        assert numbers["score_gap"] < 1e-6
