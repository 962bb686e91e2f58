"""Image decoding: JPEG/PNG bytes → RGB uint8 HWC numpy.

Counterpart of ``jumbo_mae_tpu_tpu/data/decode.py``, with its backend
order: OpenCV first, PIL for what cv2 rejects or where cv2 is absent. Both
are imported only here, cv2 under ``try`` at import and PIL lazily, so a
machine without either still imports the module. Corrupt images return
``None`` so the pipeline can skip them. With neither package installed,
:func:`decode_image` raises ``ImportError`` naming both: the stream stops
at once instead of skipping every sample, and never yields a wrong array.
"""

from __future__ import annotations

import io
import logging

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - import guard
    import cv2

    cv2.setNumThreads(0)  # decode parallelism belongs to the worker pool
except ImportError:  # pragma: no cover
    cv2 = None

IMAGE_EXTS = ("jpg", "jpeg", "png", "ppm", "bmp", "webp")
NO_BACKEND = "cannot decode images: neither cv2 (opencv-python) nor PIL (Pillow) is installed"


def backend() -> str:
    """The decoder :func:`decode_image` tries first: ``"cv2"``, ``"PIL"``,
    or ``"none"`` when neither imports."""
    if cv2 is not None:
        return "cv2"
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def decode_image(payload: bytes) -> np.ndarray | None:
    """Decode image bytes to (H, W, 3) RGB uint8, or None if undecodable.
    Raises ``ImportError`` when neither cv2 nor PIL imports."""
    if cv2 is not None:
        buf = np.frombuffer(payload, np.uint8)
        bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if bgr is not None:
            return np.ascontiguousarray(bgr[..., ::-1])
    try:
        from PIL import Image
    except ImportError:
        if cv2 is None:
            raise ImportError(NO_BACKEND) from None
        logger.warning("undecodable image (%d bytes): cv2 rejected it and PIL is not installed", len(payload))
        return None
    try:
        with Image.open(io.BytesIO(payload)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 - any decode failure → skip sample
        logger.warning("undecodable image (%d bytes): %s", len(payload), e)
        return None


def decode_label(payload: bytes | str) -> int:
    """Decode a ``.cls`` member (ASCII integer) to int."""
    if isinstance(payload, bytes):
        payload = payload.decode("utf-8")
    return int(payload.strip())


def find_image_key(sample: dict) -> str | None:
    for ext in IMAGE_EXTS:
        if ext in sample:
            return ext
    return None
