"""Synthetic Hyper-Kvasir-shaped dataset generator (copy of
``endoscopy_tpu/data/synthetic.py``).

It writes a JPEG tree plus CSVs with the reference schema's columns
``image`` / ``target`` / ``is_valid`` / ``is_labeled`` (the mock-SSL split)
and a separate unlabeled pool CSV with ``pred`` (the real-SSL filter
column). Classes are color-separable (a distinct base color per class,
noise and a radial vignette like an endoscope's illumination), so small
models can learn them.

The same arguments draw the same ``default_rng(seed)`` stream in the same
order as the JAX package's generator, so the pixels before encoding are
its pixels bit for bit. The JPEGs are encoded at quality 92 with 4:2:0
chroma, as the JAX generator's cv2 writes them: on the CPU by the native
core's libjpeg (``data/native_loader.py::write_jpeg``: the JAX generator's
files byte for byte on the build host), on the card (the default) by
nvJPEG (``data/jpeg_card.py::write_jpeg``: the same images, other bytes).
The CSVs are written by the ``csv`` module in pandas'
``to_csv(index=False)`` format, so neither cv2 nor pandas is needed.
"""

from __future__ import annotations

import csv
import functools
import os
from typing import List, Tuple

import numpy as np

from endoscopy_tpu_torch.device import resolve_device

# Distinct, well-separated base RGB colors (cycled beyond 12 classes).
_PALETTE = np.array([
    (200, 60, 60), (60, 200, 60), (60, 60, 200), (200, 200, 60),
    (200, 60, 200), (60, 200, 200), (230, 140, 40), (140, 40, 230),
    (40, 230, 140), (120, 120, 120), (230, 230, 230), (90, 50, 20),
], np.float32)


def _class_image(rng: np.random.Generator, cls: int, img_size: int) -> np.ndarray:
    base = _PALETTE[cls % len(_PALETTE)] * (0.75 + 0.5 * (cls // len(_PALETTE)))
    img = np.broadcast_to(base, (img_size, img_size, 3)).copy()
    img += rng.normal(0.0, 18.0, img.shape)
    # radial vignette (endoscope-like illumination falloff)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    c = (img_size - 1) / 2.0
    r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2) / (c * np.sqrt(2.0))
    img *= (1.0 - 0.35 * r)[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_csv(path: str, header: List[str], rows: List[tuple]) -> None:
    """pandas' ``to_csv(index=False)``: a header line, '\\n' line ends,
    minimal quoting, booleans as ``True``/``False``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def make_synthetic_dataset(root: str, num_classes: int = 4, n_train: int = 32,
                           n_valid: int = 12, n_unlabeled: int = 16,
                           img_size: int = 48, labeled_frac: float = 0.5,
                           seed: int = 0, device=None
                           ) -> Tuple[str, str, str, str]:
    """Generate a synthetic dataset under ``root``, its JPEGs encoded on
    ``device`` (``cuda`` by default, ``cpu`` when asked for).

    Returns ``(img_root, anno_csv, unl_root, unanno_csv)``:

    - ``img_root``/``anno_csv``: labeled tree + annotation CSV with columns
      ``image, target, is_valid, is_labeled``. Train rows cycle classes
      round-robin for balance; ``is_labeled`` marks ~``labeled_frac`` of each
      class's train rows (the mock-SSL split contract).
    - ``unl_root``/``unanno_csv``: separate unlabeled pool with columns
      ``image, pred`` (all ``pred=1``: every row passes the real-SSL
      filter).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        from endoscopy_tpu_torch.data import jpeg_card
        write_jpeg = functools.partial(jpeg_card.write_jpeg, device=dev)
    else:
        from endoscopy_tpu_torch.data.native_loader import write_jpeg
    rng = np.random.default_rng(seed)
    img_root = os.path.join(root, "labeled_images")
    unl_root = os.path.join(root, "unlabeled_images")
    os.makedirs(img_root, exist_ok=True)
    os.makedirs(unl_root, exist_ok=True)

    rows = []
    for i in range(n_train + n_valid):
        cls = i % num_classes
        name = f"img_{i:05d}.jpg"
        write_jpeg(os.path.join(img_root, name), _class_image(rng, cls, img_size))
        is_valid = i >= n_train
        # within each class's train rows, the first labeled_frac are labeled
        rank_in_class = i // num_classes
        per_class_train = max(1, n_train // num_classes)
        is_labeled = (not is_valid) and (
            rank_in_class < max(1, int(round(per_class_train * labeled_frac))))
        rows.append((name, cls, is_valid, is_labeled))
    anno_csv = os.path.join(root, "anno.csv")
    _write_csv(anno_csv, ["image", "target", "is_valid", "is_labeled"], rows)

    urows = []
    for i in range(n_unlabeled):
        cls = int(rng.integers(0, num_classes))
        name = f"unl_{i:05d}.jpg"
        write_jpeg(os.path.join(unl_root, name), _class_image(rng, cls, img_size))
        urows.append((name, 1))
    unanno_csv = os.path.join(root, "unanno.csv")
    _write_csv(unanno_csv, ["image", "pred"], urows)

    return img_root, anno_csv, unl_root, unanno_csv
