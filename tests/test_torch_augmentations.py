"""Port parity for ``segfusion_tpu_torch.data.augmentations``: each of the
15 factory keys, the factory over all of them and the factory-less
``FreeScale``, on the same (image, mask) pair under the same seed
(``random.seed(s)`` for the JAX module, which draws from the module-level
``random``; ``random.Random(s)`` for the port's ``Compose``), must give
the JAX package's image and mask exactly, dtypes included. Where a
transform cannot have to enlarge a crop, the mask stays label-valued."""

import random

import numpy as np
import pytest

from segfusion_tpu.data import augmentations as j_aug
from segfusion_tpu_torch.data import augmentations as aug
from segfusion_tpu_torch.setup import get_composed_augmentations

# key -> parameter: half-size crops for the random rescales (a scale of
# 0.5 or more never makes them enlarge); full-size ones below
KEYS = {"gamma": 0.3, "hue": 0.2, "brightness": 0.3, "saturation": 0.3,
        "contrast": 0.3, "rcrop": 24, "ccrop": (20, 28), "hflip": 0.5,
        "vflip": 0.5, "scale": 32, "rscale_crop": 20, "rsize": 20,
        "rsizecrop": 30, "rotate": 15, "translate": 6}
SEEDS = range(4)


def pair(h=40, w=48, classes=5):
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = rng.randint(0, classes, (h, w)).astype(np.uint8)
    return img, mask


def run_both(spec, seed):
    img, mask = pair()
    random.seed(seed)
    want = j_aug.get_composed_augmentations(spec)(img, mask)
    got = get_composed_augmentations(spec, rng=random.Random(seed))(img,
                                                                    mask)
    return got, want


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_each_key_matches_jax(key):
    for seed in SEEDS:
        got, want = run_both({key: KEYS[key]}, seed)
        assert_same(got, want)
        assert set(np.unique(got[1])) <= set(range(5)), (key, seed)


@pytest.mark.parametrize("key,param", [("rscale_crop", 40), ("rsize", 44),
                                       ("rcrop", 56)])
def test_enlarging_crops_match_jax(key, param):
    """Crops larger than the (rescaled) frame: both packages resize the
    pair to the crop with PIL's default filter, the mask included (so it
    may leave the label set, as in the JAX package)."""
    for seed in SEEDS:
        assert_same(*run_both({key: param}, seed))


def test_all_keys_in_one_compose_match_jax():
    for seed in SEEDS:
        got, want = run_both(KEYS, seed)
        assert_same(got, want)
        assert set(np.unique(got[1])) <= set(range(5))


def test_free_scale_and_empty_factory_match_jax():
    img, mask = pair()
    want = j_aug.Compose([j_aug.FreeScale((30, 36))])(img, mask)
    got = aug.Compose([aug.FreeScale((30, 36))])(img, mask)
    assert_same(got, want)
    assert got[0].shape == (30, 36, 3)
    assert get_composed_augmentations({}) is None
    assert get_composed_augmentations(None) is None
    with pytest.raises(NotImplementedError, match="blur"):
        get_composed_augmentations({"blur": 1})


def test_seeded_streams_repeat():
    """One seed, one stream: two Composes seeded alike agree, and the
    draws come from the Compose's generator only."""
    img, mask = pair()
    a = get_composed_augmentations(KEYS, rng=random.Random(3))
    b = get_composed_augmentations(KEYS, rng=random.Random(3))
    random.seed(11)
    untouched = random.random()
    random.seed(11)
    assert_same(a(img, mask), b(img, mask))
    assert random.random() == untouched
