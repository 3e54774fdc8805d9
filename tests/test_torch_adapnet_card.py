"""The segmenter's CUDA graphs on the card (``models/adapnet.py``
``SegmenterAdapter``): a replay gives the eager ``model.logits``' bits at
the accuracy cells' shapes (stage 2, 30 classes, bf16, 256², batches of 1
and 8), each call keeps its own result, a parameter whose storage moved
captures anew, and a call inside another capture or in train mode runs
eager.

Marked ``card``; each test skips where torch sees no CUDA card. Run them on
the card without the JAX package (the tests' ``conftest.py`` imports it):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_adapnet_card.py -m card
"""

import pytest
import torch

from segfusion_tpu_torch.config import Config
from segfusion_tpu_torch.models.adapnet import SegmenterAdapter, build_adapnet
from segfusion_tpu_torch.models.cuda_graphs import _SEEN
from segfusion_tpu_torch.utils import tracing

HW = 256
N_CLASSES = 30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


def _adapter(device, seed):
    """A bf16 stage-2 AdapNet++ on ``device`` with seeded weights and
    BatchNorm statistics drawn away from identity, behind the adapter."""
    torch.manual_seed(seed)
    net = build_adapnet(Config({"n_classes": N_CLASSES, "stage": 2,
                                "compute_dtype": "bfloat16"}))
    net = net.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    return SegmenterAdapter(net), gen


def _frames(gen, b, device):
    """(B, 256, 256, 3) images in 0..255 and (B, 256, 256) depths."""
    images = torch.empty((b, HW, HW, 3), device=device).uniform_(
        0.0, 255.0, generator=gen)
    depths = torch.empty((b, HW, HW), device=device).uniform_(
        0.3, 4.0, generator=gen)
    return images, depths


def _eager(seg, images, depths):
    """The eager ``model.logits`` of the adapter's inputs, NHWC."""
    img = (images / 255.0).permute(0, 3, 1, 2)
    dep = depths[:, None].expand(-1, 3, -1, -1)
    with torch.no_grad():
        return seg.model.logits(img, dep).permute(0, 2, 3, 1)


def _counts(tr):
    c = tr.counters
    return tuple(c.get(f"adapnet.{k}", 0)
                 for k in ("eager", "captures", "replays"))


def _max_gap(a, b):
    return float((a - b).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 8], ids=["live", "stream"])
def test_replay_is_the_eager_forward(card, b):
    """n calls at one signature, each on other frames: one eager call, one
    capture, n - 1 replays (the capturing call replays); every result,
    read after all the calls ran, equals the eager ``model.logits`` of its
    frames bit for bit, so two replays in a row each keep their own."""
    seg, gen = _adapter(card, seed=b)
    frames = [_frames(gen, b, card) for _ in range(5)]
    with tracing.enabled() as tr:
        got = [seg.apply_fn_batched(*f) for f in frames]
    want = [_eager(seg, *f) for f in frames]
    assert _counts(tr) == (1, 1, 4), tr.counters
    assert got[0].shape == (b, HW, HW, N_CLASSES)
    assert bool(torch.isfinite(want[0]).all())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w), _max_gap(g, w)
    assert not torch.equal(got[3], got[4])


@pytest.mark.card
def test_moved_storage_captures_anew(card):
    """An in-place parameter change is read by the next replay; a
    parameter whose storage moved drops every graph: the next call runs
    eager, the one after captures anew and replays the new numbers."""
    seg, gen = _adapter(card, seed=3)
    x = _frames(gen, 1, card)
    conv = seg.model.decoder.Conv_6
    seg.apply_fn_batched(*x), seg.apply_fn_batched(*x)
    with torch.no_grad():
        conv.weight.mul_(1.5)
    with tracing.enabled() as tr:
        inplace = seg.apply_fn_batched(*x)
    assert _counts(tr) == (0, 0, 1)
    assert torch.equal(inplace, _eager(seg, *x))
    conv.weight.data = conv.weight.data * 2.0
    with tracing.enabled() as tr:
        got = [seg.apply_fn_batched(*x) for _ in range(3)]
    assert _counts(tr) == (1, 1, 2)
    want = _eager(seg, *x)
    for g in got:
        assert torch.equal(g, want), _max_gap(g, want)
    assert not torch.equal(inplace, want)


@pytest.mark.card
def test_inside_a_capture_runs_eager(card):
    """A call made while the stream captures another graph runs eager (it
    is recorded into that graph), and the outer graph's replay gives the
    eager numbers."""
    seg, gen = _adapter(card, seed=5)
    x = _frames(gen, 1, card)
    want = _eager(seg, *x)
    seg.apply_fn_batched(*x)
    outer = torch.cuda.CUDAGraph()
    with tracing.enabled() as tr:
        with torch.cuda.graph(outer):
            y = seg.apply_fn_batched(*x)
    outer.replay()
    torch.cuda.synchronize(card)
    assert _counts(tr) == (1, 0, 0)
    assert list(seg._graphs.values()) == [_SEEN]
    assert torch.equal(y, want), _max_gap(y, want)


@pytest.mark.card
def test_train_mode_runs_eager(card):
    """With the model in train mode every call runs eager and captures
    nothing; the same dropout draws give the same logits."""
    seg, gen = _adapter(card, seed=6)
    x = _frames(gen, 2, card)
    seg.model.train()
    got = []
    with tracing.enabled() as tr:
        for _ in range(3):
            seg.model.set_dropout_generator(
                torch.Generator(device=card).manual_seed(7))
            got.append(seg.apply_fn_batched(*x))
    assert _counts(tr) == (3, 0, 0)
    assert not seg._graphs
    assert torch.equal(got[1], got[2])
