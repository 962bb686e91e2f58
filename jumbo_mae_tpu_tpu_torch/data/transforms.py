"""Host-side image transforms (numpy/cv2), torchvision/timm-equivalent.

Counterpart of ``jumbo_mae_tpu_tpu/data/transforms.py``: the same
functions, distributions and backend order (cv2 for resizing and hue, PIL
where cv2 is absent), so a transform given the same image, backend and
``np.random.Generator`` gives the same bytes in both packages. Every
function takes an explicit generator, so a worker's sample stream is
reproducible from one seed. The module imports neither torch nor PIL at
import time: data workers stay torch-free.

Train crops follow the reference's RandomResizedCrop (scale 0.2–1.0,
bicubic) or its "src" mode (Resize + RandomCrop pad-4 reflect), then
HFlip, optional ColorJitter and optional RandomErasing(value="random");
eval is Resize(size/crop_ratio) + CenterCrop. Images are (H, W, C) uint8
RGB throughout; the uint8 → float normalization runs on the device
(``ops/preprocess.py``).
"""

from __future__ import annotations

import math

import numpy as np

try:  # pragma: no cover
    import cv2

    cv2.setNumThreads(0)
except ImportError:  # pragma: no cover
    cv2 = None

_CV2_INTERP = {}
if cv2 is not None:
    _CV2_INTERP = {
        "bilinear": cv2.INTER_LINEAR,
        "bicubic": cv2.INTER_CUBIC,
        "nearest": cv2.INTER_NEAREST,
        "area": cv2.INTER_AREA,
    }


def backend() -> str:
    """The backend :func:`resize` takes: ``"cv2"``, ``"PIL"``, or
    ``"none"`` when neither imports."""
    if cv2 is not None:
        return "cv2"
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def resize(img: np.ndarray, size: tuple[int, int], interpolation: str = "bicubic") -> np.ndarray:
    """Resize to (height, width)."""
    h, w = size
    if img.shape[:2] == (h, w):
        return img
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=_CV2_INTERP[interpolation])
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("cannot resize images: neither cv2 (opencv-python) nor PIL (Pillow) is installed") from None

    pil = Image.fromarray(img).resize(
        (w, h), {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST, "area": Image.BOX}[interpolation]
    )
    return np.asarray(pil)


def resize_shorter(img: np.ndarray, shorter: int, interpolation: str = "bicubic") -> np.ndarray:
    h, w = img.shape[:2]
    if h <= w:
        return resize(img, (shorter, max(1, round(w * shorter / h))), interpolation)
    return resize(img, (max(1, round(h * shorter / w)), shorter), interpolation)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:  # pad-to-fit like torchvision CenterCrop
        pt, pl = max(0, (size - h) // 2), max(0, (size - w) // 2)
        img = np.pad(
            img,
            ((pt, max(0, size - h - pt)), (pl, max(0, size - w - pl)), (0, 0)),
        )
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top : top + size, left : left + size]


def eval_transform(
    img: np.ndarray, size: int, *, crop_ratio: float = 0.875, interpolation: str = "bicubic"
) -> np.ndarray:
    """Resize(size / crop_ratio) shorter side + CenterCrop(size) — the
    reference's eval pipeline."""
    img = resize_shorter(img, int(round(size / crop_ratio)), interpolation)
    return center_crop(img, size)


def random_resized_crop(
    rng: np.random.Generator,
    img: np.ndarray,
    size: int,
    *,
    scale: tuple[float, float] = (0.2, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
    interpolation: str = "bicubic",
) -> np.ndarray:
    """torchvision RandomResizedCrop distribution: 10 rejection-sampling
    attempts over (area, log-uniform aspect), then central fallback."""
    h, w = img.shape[:2]
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top : top + ch, left : left + cw]
            return resize(crop, (size, size), interpolation)
    # fallback: center crop at the in-range aspect closest to the image's
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    top, left = (h - ch) // 2, (w - cw) // 2
    return resize(img[top : top + ch, left : left + cw], (size, size), interpolation)


def simple_resize_crop(
    rng: np.random.Generator, img: np.ndarray, size: int, *, interpolation: str = "bicubic"
) -> np.ndarray:
    """The reference's "src" mode: Resize(size) + RandomCrop(size, padding=4,
    reflect)."""
    img = resize_shorter(img, size, interpolation)
    img = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="reflect")
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top : top + size, left : left + size]


def random_hflip(rng: np.random.Generator, img: np.ndarray, p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = b.astype(np.float32) + factor * (a.astype(np.float32) - b.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # PIL semantics: blend toward the mean of the grayscale image
    gray = (img @ np.array([0.299, 0.587, 0.114], np.float32)).mean()
    return _blend(img, np.full_like(img, int(gray + 0.5)), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
    return _blend(img, gray[..., None].repeat(3, axis=-1), factor)


def adjust_hue(img: np.ndarray, delta: float) -> np.ndarray:
    """delta in [-0.5, 0.5] turns of the hue wheel."""
    if cv2 is None or abs(delta) < 1e-8:
        return img
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(round(delta * 180))) % 180
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def color_jitter(
    rng: np.random.Generator,
    img: np.ndarray,
    strength: float,
    *,
    hue: float = 0.0,
) -> np.ndarray:
    """torchvision ColorJitter(strength, strength, strength[, hue]): each of
    brightness/contrast/saturation drawn from U[max(0,1-s), 1+s], applied in
    a random order."""
    ops = []
    for fn in (adjust_brightness, adjust_contrast, adjust_saturation):
        factor = rng.uniform(max(0.0, 1 - strength), 1 + strength)
        ops.append((fn, factor))
    if hue > 0:
        ops.append((adjust_hue, rng.uniform(-hue, hue)))
    for i in rng.permutation(len(ops)):
        fn, factor = ops[i]
        img = fn(img, factor)
    return img


def random_erasing(
    rng: np.random.Generator,
    img: np.ndarray,
    p: float,
    *,
    scale: tuple[float, float] = (0.02, 1 / 3),
    ratio: tuple[float, float] = (0.3, 3.3),
    attempts: int = 10,
) -> np.ndarray:
    """torchvision RandomErasing(value="random"): erase a random rect with
    uniform noise. Mutates a copy; returns the input untouched with prob 1-p."""
    if rng.random() >= p:
        return img
    h, w = img.shape[:2]
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(attempts):
        target = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if 0 < eh < h and 0 < ew < w:
            top = int(rng.integers(0, h - eh + 1))
            left = int(rng.integers(0, w - ew + 1))
            out = img.copy()
            out[top : top + eh, left : left + ew] = rng.integers(
                0, 256, (eh, ew, img.shape[2]), dtype=np.uint8
            )
            return out
    return img
