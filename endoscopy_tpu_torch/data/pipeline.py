"""Canonical uint8 host helpers (subset of ``endoscopy_tpu/data/pipeline.py``).

The host ships ONE canonical uint8 NHWC batch per role, at
``IMG_SIZE × DATA.CANONICAL_SCALE`` when ``IS_CROP``; every view derives
from it on the device. ``cv2`` is imported only by the decoders, so the
serving path that takes raw canonical buffers needs no OpenCV.
"""

from __future__ import annotations

import numpy as np


def canonical_size(config) -> int:
    """IMG_SIZE × CANONICAL_SCALE when IS_CROP (the reference's
    ``int(size * 1.2)`` resize before crops), else IMG_SIZE."""
    img_size = int(config.DATA.IMG_SIZE)
    if config.DATA.IS_CROP:
        return int(img_size * float(config.DATA.CANONICAL_SCALE))
    return img_size


def decode_canonical(path: str, size: int) -> np.ndarray:
    """cv2 imread → BGR2RGB → bilinear resize to (size, size) uint8."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read image: {path}")
    return _canonicalize_bgr(img, size)


def decode_canonical_bytes(data: bytes, size: int) -> np.ndarray:
    """Encoded image bytes (JPEG/PNG/...) → canonical uint8 (size, size, 3)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cv2 could not decode the image payload")
    return _canonicalize_bgr(img, size)


def _canonicalize_bgr(img: np.ndarray, size: int) -> np.ndarray:
    import cv2

    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[0] != size or img.shape[1] != size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return np.ascontiguousarray(img, dtype=np.uint8)
