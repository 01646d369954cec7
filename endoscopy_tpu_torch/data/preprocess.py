"""Offline preprocessing (copy of ``endoscopy_tpu/data/preprocess.py``;
reference L1: Preprocess.ipynb + utils.py:136-152).

The reference prepares raw Hyper-Kvasir downloads offline before any
training: contour-crop the circular endoscope view out of the black frame
(``crop_square``, Preprocess.ipynb cell 31), optionally un-distort the
elliptical lens view (``deformation``, cell 29), and resize so the minimum
edge is 336 px (cell 42, via ``resize_aspect_ratio`` utils.py:136-152),
fanning the work over a process pool (cell 38 ``mp.Pool(8)``).

These are host-side one-shot transforms (run once per dataset), so plain
cv2/numpy is the right tool, as in the JAX package, which keeps them off
the accelerator on purpose; the port has no card version of them. The
threaded tree map mirrors the reference's pool fan-out with threads (cv2
releases the GIL in decode/resize). cv2 is imported by each function.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np


def resize_aspect_ratio(img: np.ndarray, min_edge: int = 336) -> np.ndarray:
    """Resize so the shorter edge equals ``min_edge``, preserving aspect
    ratio (utils.py:136-152). No-op when already smaller or equal."""
    import cv2

    h, w = img.shape[:2]
    short = min(h, w)
    if short == min_edge:
        return img
    scale = min_edge / float(short)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    interp = cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR
    return cv2.resize(img, (new_w, new_h), interpolation=interp)


def crop_square(img: np.ndarray, thresh: int = 10) -> np.ndarray:
    """Crop the bright (non-black-border) content region to a square
    (Preprocess.ipynb cell 31: contour crop of the endoscope circle).

    Finds the bounding box of pixels above ``thresh`` in the gray image and
    center-crops the longer box edge to a square.
    """
    import cv2

    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    mask = gray > thresh
    if not mask.any():
        return img
    ys, xs = np.nonzero(mask)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    crop = img[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    edge = min(h, w)
    oy, ox = (h - edge) // 2, (w - edge) // 2
    return crop[oy:oy + edge, ox:ox + edge]


def elliptical_deformation(img: np.ndarray, strength: float = 0.15
                           ) -> np.ndarray:
    """Radial un-distortion of the elliptical endoscope view
    (Preprocess.ipynb cell 29 ``deformation()``): remap each pixel along its
    ray from the image center by a radius-dependent factor, pulling the
    squeezed periphery outward. ``strength=0`` is the identity."""
    import cv2

    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    r = np.sqrt((dy / cy) ** 2 + (dx / cx) ** 2)  # normalized ellipse radius
    factor = 1.0 + strength * np.clip(r, 0.0, 1.0) ** 2
    map_x = cx + dx * factor
    map_y = cy + dy * factor
    return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)


def preprocess_image(img: np.ndarray, min_edge: int = 336,
                     do_crop: bool = True, deform: Optional[float] = None
                     ) -> np.ndarray:
    """Full reference pipeline: crop → (optional) deform → resize."""
    if do_crop:
        img = crop_square(img)
    if deform:
        img = elliptical_deformation(img, deform)
    return resize_aspect_ratio(img, min_edge)


def preprocess_tree(src_root: str, dst_root: str, min_edge: int = 336,
                    do_crop: bool = True, deform: Optional[float] = None,
                    num_workers: int = 8, quality: int = 95) -> int:
    """Apply :func:`preprocess_image` to every JPEG under ``src_root``,
    mirroring the directory layout into ``dst_root`` (the reference's
    ``mp.Pool(8)`` tree map, Preprocess.ipynb cell 38). Returns the number
    of images written."""
    import cv2

    jobs = []
    for dirpath, _, files in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        out_dir = os.path.join(dst_root, rel) if rel != "." else dst_root
        os.makedirs(out_dir, exist_ok=True)
        for f in files:
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                # Source filenames are preserved (annotation CSVs reference
                # them verbatim, and renaming x.png -> x.jpg would collide
                # with a sibling x.jpg); cv2.imwrite picks the codec from
                # the extension, so each format gets its own encode params
                # instead of PNGs silently ignoring the JPEG quality flag.
                jobs.append((os.path.join(dirpath, f),
                             os.path.join(out_dir, f)))

    def work(job) -> bool:
        src, dst = job
        bgr = cv2.imread(src)
        if bgr is None:
            return False
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        out = preprocess_image(rgb, min_edge, do_crop, deform)
        params = ([cv2.IMWRITE_JPEG_QUALITY, quality]
                  if dst.lower().endswith((".jpg", ".jpeg"))
                  else [cv2.IMWRITE_PNG_COMPRESSION, 3])
        return bool(cv2.imwrite(dst, cv2.cvtColor(out, cv2.COLOR_RGB2BGR),
                                params))

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        return sum(pool.map(work, jobs))
