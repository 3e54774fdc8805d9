"""Paired image + label-mask augmentations (host-side, numpy/PIL).

Port of ``segfusion_tpu/data/augmentations.py``: 15 paired transforms;
the photometric ones touch only the image, the geometric ones move image
and mask together (nearest-neighbour for the mask, so it stays
label-valued). The factory's key map is the JAX package's. Every random
draw comes from the ``random.Random`` that :class:`Compose` holds and
passes to each transform, so a seeded generator gives a reproducible
stream (the JAX module draws the same sequence from the module-level
``random`` seeded alike).
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

__all__ = ["Compose", "get_composed_augmentations"]


def _to_pil(img):
    from PIL import Image
    if isinstance(img, np.ndarray):
        arr = np.clip(img, 0, 255).astype(np.uint8)
        return Image.fromarray(arr)
    return img


def _pil_pair(img, mask):
    from PIL import Image
    pm = Image.fromarray(np.asarray(mask).astype(np.uint8)) \
        if isinstance(mask, np.ndarray) else mask
    return _to_pil(img), pm


class Compose:
    """The transforms in order over one (image, mask) pair; returns
    (float32 image, uint8 mask) arrays. ``rng``: the generator every
    transform draws from (a fresh ``random.Random()`` by default)."""

    def __init__(self, augmentations: Sequence,
                 rng: Optional[random.Random] = None):
        self.augmentations = augmentations
        self.rng = random.Random() if rng is None else rng

    def __call__(self, img, mask):
        img, mask = _pil_pair(img, mask)
        for a in self.augmentations:
            img, mask = a(img, mask, self.rng)
        return np.asarray(img, np.float32), np.asarray(mask, np.uint8)


class AdjustGamma:
    def __init__(self, gamma):
        self.gamma = gamma

    def __call__(self, img, mask, rng):
        arr = np.asarray(img, np.float32) / 255.0
        g = rng.uniform(1, 1 + self.gamma)
        return _to_pil((arr ** g) * 255.0), mask


class AdjustSaturation:
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, img, mask, rng):
        from PIL import ImageEnhance
        f = rng.uniform(1 - self.saturation, 1 + self.saturation)
        return ImageEnhance.Color(img).enhance(f), mask


class AdjustHue:
    def __init__(self, hue):
        self.hue = hue

    def __call__(self, img, mask, rng):
        from PIL import Image
        shift = rng.uniform(-self.hue, self.hue)
        hsv = np.asarray(img.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
        out = Image.frombytes("HSV", img.size, hsv.astype(np.uint8).tobytes())
        return out.convert("RGB"), mask


class AdjustBrightness:
    def __init__(self, bf):
        self.bf = bf

    def __call__(self, img, mask, rng):
        from PIL import ImageEnhance
        f = rng.uniform(1 - self.bf, 1 + self.bf)
        return ImageEnhance.Brightness(img).enhance(f), mask


class AdjustContrast:
    def __init__(self, cf):
        self.cf = cf

    def __call__(self, img, mask, rng):
        from PIL import ImageEnhance
        f = rng.uniform(1 - self.cf, 1 + self.cf)
        return ImageEnhance.Contrast(img).enhance(f), mask


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img, mask, rng):
        from PIL import ImageOps
        if self.padding:
            img = ImageOps.expand(img, border=self.padding, fill=0)
            mask = ImageOps.expand(mask, border=self.padding, fill=0)
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img, mask
        if w < tw or h < th:
            return (img.resize((tw, th)), mask.resize((tw, th)))
        x1 = rng.randint(0, w - tw)
        y1 = rng.randint(0, h - th)
        box = (x1, y1, x1 + tw, y1 + th)
        return img.crop(box), mask.crop(box)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, mask, rng=None):
        w, h = img.size
        th, tw = self.size
        x1 = (w - tw) // 2
        y1 = (h - th) // 2
        box = (x1, y1, x1 + tw, y1 + th)
        return img.crop(box), mask.crop(box)


class RandomHorizontallyFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask, rng):
        from PIL import Image
        if rng.random() < self.p:
            return (img.transpose(Image.Transpose.FLIP_LEFT_RIGHT),
                    mask.transpose(Image.Transpose.FLIP_LEFT_RIGHT))
        return img, mask


class RandomVerticallyFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, mask, rng):
        from PIL import Image
        if rng.random() < self.p:
            return (img.transpose(Image.Transpose.FLIP_TOP_BOTTOM),
                    mask.transpose(Image.Transpose.FLIP_TOP_BOTTOM))
        return img, mask


class FreeScale:
    def __init__(self, size):
        self.size = tuple(reversed(size))  # (w, h)

    def __call__(self, img, mask, rng=None):
        from PIL import Image
        return (img.resize(self.size, Image.Resampling.BILINEAR),
                mask.resize(self.size, Image.Resampling.NEAREST))


class RandomScaleCrop:
    def __init__(self, size):
        self.size = size
        self.crop = RandomCrop(size)

    def __call__(self, img, mask, rng):
        from PIL import Image
        scale = rng.uniform(0.5, 2.0)
        w, h = img.size
        nw, nh = int(w * scale), int(h * scale)
        img = img.resize((nw, nh), Image.Resampling.BILINEAR)
        mask = mask.resize((nw, nh), Image.Resampling.NEAREST)
        return self.crop(img, mask, rng)


class RandomTranslate:
    def __init__(self, offset):
        self.offset = (offset, offset) if isinstance(offset, (int, float)) \
            else tuple(offset)

    def __call__(self, img, mask, rng):
        from PIL import Image
        dx = int(rng.uniform(-1, 1) * self.offset[0])
        dy = int(rng.uniform(-1, 1) * self.offset[1])
        shift = (1, 0, -dx, 0, 1, -dy)
        return (img.transform(img.size, Image.Transform.AFFINE, shift),
                mask.transform(mask.size, Image.Transform.AFFINE, shift))


class RandomRotate:
    def __init__(self, degree):
        self.degree = degree

    def __call__(self, img, mask, rng):
        from PIL import Image
        d = rng.uniform(-self.degree, self.degree)
        return (img.rotate(d, Image.Resampling.BILINEAR),
                mask.rotate(d, Image.Resampling.NEAREST))


class RandomSized:
    def __init__(self, size):
        self.size = size
        self.crop = RandomCrop(size)

    def __call__(self, img, mask, rng):
        from PIL import Image
        scale = rng.uniform(0.5, 2.0)
        w = int(scale * img.size[0])
        h = int(scale * img.size[1])
        img = img.resize((w, h), Image.Resampling.BILINEAR)
        mask = mask.resize((w, h), Image.Resampling.NEAREST)
        return self.crop(img, mask, rng)


class Scale:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, mask, rng=None):
        from PIL import Image
        w, h = img.size
        if (w >= h and w == self.size) or (h >= w and h == self.size):
            return img, mask
        if w > h:
            ow = self.size
            oh = int(self.size * h / w)
        else:
            oh = self.size
            ow = int(self.size * w / h)
        return (img.resize((ow, oh), Image.Resampling.BILINEAR),
                mask.resize((ow, oh), Image.Resampling.NEAREST))


class RandomSizedCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, mask, rng):
        from PIL import Image
        for _ in range(10):
            area = img.size[0] * img.size[1]
            target_area = rng.uniform(0.45, 1.0) * area
            aspect = rng.uniform(0.5, 2.0)
            w = int(round((target_area * aspect) ** 0.5))
            h = int(round((target_area / aspect) ** 0.5))
            if rng.random() < 0.5:
                w, h = h, w
            if w <= img.size[0] and h <= img.size[1]:
                x1 = rng.randint(0, img.size[0] - w)
                y1 = rng.randint(0, img.size[1] - h)
                img2 = img.crop((x1, y1, x1 + w, y1 + h))
                mask2 = mask.crop((x1, y1, x1 + w, y1 + h))
                size = (self.size, self.size)
                return (img2.resize(size, Image.Resampling.BILINEAR),
                        mask2.resize(size, Image.Resampling.NEAREST))
        return CenterCrop(self.size)(*Scale(self.size)(img, mask))


# factory key map (the JAX package's)
_KEY2AUG = {
    "gamma": AdjustGamma,
    "hue": AdjustHue,
    "brightness": AdjustBrightness,
    "saturation": AdjustSaturation,
    "contrast": AdjustContrast,
    "rcrop": RandomCrop,
    "ccrop": CenterCrop,
    "hflip": RandomHorizontallyFlip,
    "vflip": RandomVerticallyFlip,
    "scale": Scale,
    "rscale_crop": RandomScaleCrop,
    "rsize": RandomSized,
    "rsizecrop": RandomSizedCrop,
    "rotate": RandomRotate,
    "translate": RandomTranslate,
}


def get_composed_augmentations(aug_dict, rng: Optional[random.Random] = None
                               ) -> Optional[Compose]:
    """A Compose of the {name: param} config dict's transforms in order
    (None for an empty or missing dict), drawing from ``rng``."""
    if not aug_dict:
        return None
    augs = []
    for key, param in aug_dict.items():
        if key not in _KEY2AUG:
            raise NotImplementedError(f"augmentation {key} not implemented")
        augs.append(_KEY2AUG[key](param))
    return Compose(augs, rng=rng)
