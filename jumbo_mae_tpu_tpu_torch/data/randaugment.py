"""Auto-augmentation policies: RandAugment, AugMix and AutoAugment.

Counterpart of ``jumbo_mae_tpu_tpu/data/randaugment.py``, copied: the timm
policy grammar (``rand-m9-mstd0.5-inc1``, ``augmix-m3-w3-d2``,
``original``), the same ops on PIL images (the backend timm used, so
equalize, posterize and shear have its pixel semantics) and the same
draws from an explicit ``np.random.Generator``, so both packages augment
a sample alike.

PIL is imported at the first op, not with this module: the port imports
and pretrains without PIL, and a policy asked for where PIL is missing
raises ``ImportError`` naming it. The loader's worker interpreters run
these policies and never import torch.
"""

from __future__ import annotations

import functools
import re
from types import SimpleNamespace

import numpy as np


@functools.cache
def _pil() -> SimpleNamespace:
    """PIL's ``Image``, ``ImageEnhance`` and ``ImageOps``, imported once."""
    try:
        from PIL import Image, ImageEnhance, ImageOps
    except ImportError as e:
        raise ImportError(f"data.auto_augment policies need PIL (Pillow), which does not import here: {e}") from e
    return SimpleNamespace(Image=Image, ImageEnhance=ImageEnhance, ImageOps=ImageOps)


_FILL = (128, 128, 128)
_MAX_LEVEL = 10.0


# ---------------------------------------------------------------- primitive ops
def _auto_contrast(img, *_):
    return _pil().ImageOps.autocontrast(img)


def _equalize(img, *_):
    return _pil().ImageOps.equalize(img)


def _invert(img, *_):
    return _pil().ImageOps.invert(img)


def _rotate(img, deg):
    return img.rotate(deg, resample=_pil().Image.BILINEAR, fillcolor=_FILL)


def _posterize(img, bits):
    return _pil().ImageOps.posterize(img, max(1, int(bits)))


def _solarize(img, thresh):
    return _pil().ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img).astype(np.int32)
    arr = np.where(arr < thresh, np.clip(arr + int(add), 0, 255), arr)
    return _pil().Image.fromarray(arr.astype(np.uint8))


def _color(img, factor):
    return _pil().ImageEnhance.Color(img).enhance(factor)


def _contrast(img, factor):
    return _pil().ImageEnhance.Contrast(img).enhance(factor)


def _brightness(img, factor):
    return _pil().ImageEnhance.Brightness(img).enhance(factor)


def _sharpness(img, factor):
    return _pil().ImageEnhance.Sharpness(img).enhance(factor)


def _shear_x(img, v):
    return img.transform(
        img.size, _pil().Image.AFFINE, (1, v, 0, 0, 1, 0), resample=_pil().Image.BILINEAR, fillcolor=_FILL
    )


def _shear_y(img, v):
    return img.transform(
        img.size, _pil().Image.AFFINE, (1, 0, 0, v, 1, 0), resample=_pil().Image.BILINEAR, fillcolor=_FILL
    )


def _translate_x_rel(img, pct):
    return img.transform(
        img.size,
        _pil().Image.AFFINE,
        (1, 0, pct * img.size[0], 0, 1, 0),
        resample=_pil().Image.BILINEAR,
        fillcolor=_FILL,
    )


def _translate_y_rel(img, pct):
    return img.transform(
        img.size,
        _pil().Image.AFFINE,
        (1, 0, 0, 0, 1, pct * img.size[1]),
        resample=_pil().Image.BILINEAR,
        fillcolor=_FILL,
    )


# ------------------------------------------------------------ level → op args
def _signed(rng, v):
    return -v if rng.random() < 0.5 else v


def _enhance_increasing(rng, level):
    return 1.0 + _signed(rng, (level / _MAX_LEVEL) * 0.9)


def _enhance_plain(rng, level):
    # non-"inc" variant: U-shaped range [0.1, 1.9]
    return max(0.1, (level / _MAX_LEVEL) * 1.8 + 0.1)


# name → (fn, level_to_arg(rng, level, increasing) | None)
def _level_args(name: str, rng, level: float, increasing: bool):
    if name in ("AutoContrast", "Equalize", "Invert"):
        return ()
    if name == "Rotate":
        return (_signed(rng, (level / _MAX_LEVEL) * 30.0),)
    if name == "Posterize":
        if increasing:
            return (4 - int((level / _MAX_LEVEL) * 4),)
        return (int((level / _MAX_LEVEL) * 4) + 4,)
    if name == "Solarize":
        if increasing:
            return (256 - int((level / _MAX_LEVEL) * 256),)
        return (int((level / _MAX_LEVEL) * 256),)
    if name == "SolarizeAdd":
        return (int((level / _MAX_LEVEL) * 110),)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        if increasing:
            return (_enhance_increasing(rng, level),)
        return (_enhance_plain(rng, level),)
    if name in ("ShearX", "ShearY"):
        return (_signed(rng, (level / _MAX_LEVEL) * 0.3),)
    if name in ("TranslateXRel", "TranslateYRel"):
        return (_signed(rng, (level / _MAX_LEVEL) * 0.45),)
    raise KeyError(name)


_OPS = {
    "AutoContrast": _auto_contrast,
    "Equalize": _equalize,
    "Invert": _invert,
    "Rotate": _rotate,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "SolarizeAdd": _solarize_add,
    "Color": _color,
    "Contrast": _contrast,
    "Brightness": _brightness,
    "Sharpness": _sharpness,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateXRel": _translate_x_rel,
    "TranslateYRel": _translate_y_rel,
}

_RAND_TRANSFORMS = [
    "AutoContrast",
    "Equalize",
    "Invert",
    "Rotate",
    "Posterize",
    "Solarize",
    "SolarizeAdd",
    "Color",
    "Contrast",
    "Brightness",
    "Sharpness",
    "ShearX",
    "ShearY",
    "TranslateXRel",
    "TranslateYRel",
]

_AUGMIX_TRANSFORMS = [
    "AutoContrast",
    "Equalize",
    "Rotate",
    "Posterize",
    "Solarize",
    "ShearX",
    "ShearY",
    "TranslateXRel",
    "TranslateYRel",
]


def _apply_op(img, name: str, rng, level: float, mstd: float, increasing: bool):
    if mstd > 0:
        level = level + rng.normal(0, mstd)
    level = float(np.clip(level, 0, _MAX_LEVEL))
    args = _level_args(name, rng, level, increasing)
    return _OPS[name](img, *args)


class RandAugment:
    """``rand-mN[-mstdS][-incB][-nL][-pP]``: L (default 2) ops drawn uniformly
    per image, each applied with probability P (default 0.5) at magnitude N
    (Gaussian-jittered by S)."""

    def __init__(self, magnitude=9.0, num_layers=2, mstd=0.5, increasing=False, prob=0.5):
        self.magnitude = magnitude
        self.num_layers = num_layers
        self.mstd = mstd
        self.increasing = increasing
        self.prob = prob

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        pil = _pil().Image.fromarray(img)
        for _ in range(self.num_layers):
            name = _RAND_TRANSFORMS[int(rng.integers(len(_RAND_TRANSFORMS)))]
            if rng.random() <= self.prob:
                pil = _apply_op(pil, name, rng, self.magnitude, self.mstd, self.increasing)
        return np.asarray(pil)


class AugMix:
    """``augmix-mN[-wW][-dD][-aA]``: W (default 3) chains of depth D (default
    random 1–3), convexly mixed with Dirichlet(A) weights, then blended with
    the original via Beta(A, A)."""

    def __init__(self, magnitude=3.0, width=3, depth=-1, alpha=1.0, mstd=0.0):
        self.magnitude = magnitude
        self.width = width
        self.depth = depth
        self.alpha = alpha
        self.mstd = mstd

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        ws = rng.dirichlet([self.alpha] * self.width).astype(np.float32)
        m = float(rng.beta(self.alpha, self.alpha))
        mix = np.zeros(img.shape, np.float32)
        for i in range(self.width):
            depth = self.depth if self.depth > 0 else int(rng.integers(1, 4))
            pil = _pil().Image.fromarray(img)
            for _ in range(depth):
                name = _AUGMIX_TRANSFORMS[int(rng.integers(len(_AUGMIX_TRANSFORMS)))]
                pil = _apply_op(pil, name, rng, self.magnitude, self.mstd, True)
            mix += ws[i] * np.asarray(pil, np.float32)
        out = (1 - m) * img.astype(np.float32) + m * mix
        return np.clip(out, 0, 255).astype(np.uint8)


# AutoAugment "original" ImageNet policy: (op, prob, magnitude-level) pairs.
_AUTO_POLICY = [
    [("Posterize", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("Posterize", 0.6, 7), ("Posterize", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("Posterize", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("Posterize", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


class AutoAugment:
    """The original AutoAugment ImageNet policy (25 sub-policies of 2 ops)."""

    def __init__(self, mstd: float = 0.0):
        self.mstd = mstd

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        pil = _pil().Image.fromarray(img)
        sub = _AUTO_POLICY[int(rng.integers(len(_AUTO_POLICY)))]
        for name, prob, level in sub:
            if rng.random() <= prob:
                pil = _apply_op(pil, name, rng, float(level), self.mstd, False)
        return np.asarray(pil)


def auto_augment_factory(policy: str):
    """Parse a timm-grammar policy string into a callable
    ``(rng, uint8 image) -> uint8 image``, as the JAX package's
    ``auto_augment_factory``. Returns None for falsy input."""
    if not policy or policy == "none":
        return None
    _pil()  # a policy without PIL fails here, before any sample
    parts = policy.split("-")
    kind = parts[0]
    kv: dict[str, float] = {}
    for tok in parts[1:]:
        m = re.fullmatch(r"([a-z]+)([\d.]+)", tok)
        if not m:
            raise ValueError(f"bad policy token {tok!r} in {policy!r}")
        kv[m.group(1)] = float(m.group(2))
    if kind == "rand":
        return RandAugment(
            magnitude=kv.get("m", 9.0),
            num_layers=int(kv.get("n", 2)),
            mstd=kv.get("mstd", 0.0),
            increasing=bool(int(kv.get("inc", 0))),
            prob=kv.get("p", 0.5),
        )
    if kind == "augmix":
        return AugMix(
            magnitude=kv.get("m", 3.0),
            width=int(kv.get("w", 3)),
            depth=int(kv.get("d", -1)),
            alpha=kv.get("a", 1.0),
            mstd=kv.get("mstd", 0.0),
        )
    return AutoAugment(mstd=kv.get("mstd", 0.0))
