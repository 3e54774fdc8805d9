"""The folded executor's CUDA graphs on the card (``models/fusionnet_fast.py``
``FastV3``): a replay gives the eager ``apply_v3``'s bits at the benchmark
cells' shapes, a refold captures anew, and a call inside another capture
runs eager.

Marked ``card``; each test skips where torch sees no CUDA card. Run them on
the card without the JAX package (the tests' ``conftest.py`` imports it):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_fastnet_card.py -m card
"""

import pytest
import torch

from segfusion_tpu_torch.config import default_config
from segfusion_tpu_torch.core.pipeline import Pipeline
from segfusion_tpu_torch.models import fusionnet_fast as ff
from segfusion_tpu_torch.utils import tracing

N_POINTS = 9


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


def _pipeline(device, hw, use_semantics, seed):
    """A bf16 v3 (gf 6) Pipeline on ``device`` with seeded weights and
    BatchNorm statistics drawn away from identity, so the fold matters."""
    cfg = default_config()
    cfg.DATA.resx = cfg.DATA.resy = hw
    cfg.FUSION_MODEL.update(name="v3", n_points=N_POINTS, n_tail_points=7,
                            growth_factor=6, use_semantics=use_semantics,
                            compute_dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(seed)
    pipe = Pipeline(cfg, device=device, generator=gen)
    with torch.no_grad():
        for m in pipe.fusion_net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return pipe, gen


def _frame(gen, hw, use_semantics, device):
    """One frame's net inputs, (1, hw, hw, C) float32."""
    def u(c, lo, hi):
        return torch.empty((1, hw, hw, c), device=device).uniform_(
            lo, hi, generator=gen)

    x = {"tsdf_values": u(N_POINTS, -0.1, 0.1),
         "tsdf_weights": u(N_POINTS, 0.0, 3.0),
         "tsdf_frame": u(1, 0.5, 3.0)}
    if use_semantics:
        x["semantic_frame"] = u(1, 0.0, 1.0)
    return x


def _max_gap(a, b):
    return float((a - b).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("hw,use_semantics", [(128, False), (256, True)],
                         ids=["speed", "accuracy"])
def test_replay_is_the_eager_executor(card, hw, use_semantics):
    """Through ``Pipeline._network_estimate``: an eager call, a capture,
    replays on two other frames, each equal to the eager ``apply_v3`` of
    the executor's weights bit for bit; after an in-place parameter change
    the refold runs eager once, captures anew and replays its own
    numbers."""
    pipe, gen = _pipeline(card, hw, use_semantics, seed=hw)
    frames = [_frame(gen, hw, use_semantics, card) for _ in range(4)]
    with torch.no_grad(), tracing.enabled() as tr:
        fast = pipe.prepare_params()
        got = [pipe._network_estimate(x) for x in frames]
        want = [fast._eager(x)[..., :N_POINTS] for x in frames]
        pipe.fusion_net.Pred_0.Conv_0.weight.mul_(1.5)
        refold = pipe.prepare_params()
        assert refold is not fast and not refold._graphs
        got2 = [pipe._network_estimate(x) for x in frames[:3]]
        want2 = [refold._eager(x)[..., :N_POINTS] for x in frames[:3]]
    c = tr.counters
    assert (c["fusionnet.eager"], c["fusionnet.captures"],
            c["fusionnet.replays"]) == (2, 2, 5), c
    for g, w in zip(got + got2, want + want2):
        assert torch.equal(g, w), _max_gap(g, w)
    assert not torch.equal(got[2], got2[2])


@pytest.mark.card
def test_inside_a_capture_runs_eager(card):
    """A call made while the stream captures another graph runs eager (it
    is recorded into that graph), and the outer graph's replay gives the
    eager numbers."""
    pipe, gen = _pipeline(card, 128, False, seed=5)
    x = _frame(gen, 128, False, card)
    with torch.no_grad():
        fast = pipe.prepare_params()
        want = fast._eager(x)
        fast(x)
        outer = torch.cuda.CUDAGraph()
        with tracing.enabled() as tr:
            with torch.cuda.graph(outer):
                y = fast(x)
        outer.replay()
    torch.cuda.synchronize(card)
    assert tr.counters["fusionnet.eager"] == 1
    assert "fusionnet.captures" not in tr.counters
    assert list(fast._graphs.values()) == [ff._SEEN]
    assert torch.equal(y, want), _max_gap(y, want)
