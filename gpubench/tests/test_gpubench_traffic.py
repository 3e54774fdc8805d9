"""The frames are a function of the seed: the same seed gives the same
frames, another seed another room; seeds past 32 bits are taken."""

import torch

from gpubench import scene, weights


def _frames(seed):
    room = scene.Room(0, 2.2)
    return scene.render_orbit(room, 4, 24, 32, "cpu",
                              weights.generator(seed, 3, "cpu"), 0.01)


def test_same_seed_same_frames():
    a, b = _frames(2 ** 33 + 7), _frames(2 ** 33 + 7)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_other_seed_same_orbit_other_order():
    a, b = _frames(11), _frames(12)
    assert not torch.equal(a["depth"], b["depth"])
    rolls = [k for k in range(4)
             if torch.equal(torch.roll(a["extrinsics"], -k, 0),
                            b["extrinsics"])]
    assert len(rolls) == 1


def test_closed_room_every_ray_hits():
    f = _frames(3)
    assert bool(f["mask"].all())
    assert float(f["depth"].max()) < 4 * 2.2 * 1.5


def test_orbit_step():
    poses = scene.Room(0, 2.2).orbit(512)
    step = (poses[1:, :3, 3] - poses[:-1, :3, 3])
    step = (step ** 2).sum(-1) ** 0.5
    assert 0.010 < float(step.mean()) < 0.016      # about 1.2 cm a frame
    assert abs(float(((poses[0, :3, 3] - poses[-1, :3, 3]) ** 2).sum()
                     ** 0.5) - float(step.mean())) < 0.01   # closed


def test_weights_from_seed():
    from gpubench import architectures, harness
    conf = harness.load_cell("accuracy.stream").config["config"]
    with torch.device("meta"):
        net = architectures.fusion(conf).reference(conf["FUSION_MODEL"])
    a = weights.random_state(net, weights.generator(5, 1, "cpu"), "cpu")
    b = weights.random_state(net, weights.generator(5, 1, "cpu"), "cpu")
    c = weights.random_state(net, weights.generator(6, 1, "cpu"), "cpu")
    k = "head_tsdf.Block_0.Conv_0.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    fan_in = a[k][0].numel()
    assert abs(float(a[k].std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert torch.equal(a["head_tsdf.Block_0.BatchNorm_0.running_var"],
                       torch.ones(19))
