"""Path D's data and configs: ``cli/learn.py``'s two stages on seeded images.

``chip_smoke.py`` drives ``cli/learn.py::run_config`` with them on the
card; ``learn.py`` holds the image generator against the JAX package's on
the CPU. No JAX, pandas, cv2, PIL or PyYAML: the card's machine has none.

- The images follow ``endoscopy_tpu/data/synthetic.py::_class_image``:
  each class a base colour of the same palette with Gaussian noise (std
  18) and a radial vignette, clipped to uint8; made directly at the
  canonical size, so the loaders decode nothing.
- The loaders are the port's ``CanonicalLoader`` and ``EvalLoader``
  (index stream, batch assembly, cache, pad-and-mask); the subclasses of
  :func:`array_loader` override only ``decode``, a lookup of the
  manifest's paths, which are row numbers, into the image array.
"""

from __future__ import annotations

import numpy as np
import torch

from endoscopy_tpu_torch.data.manifest import Manifest, get_cls_num_list
from endoscopy_tpu_torch.data.pipeline import (CanonicalLoader, EvalLoader,
                                               canonical_size)
from torch_port_checks import path_c

# _class_image's palette (cycled beyond 12 classes)
PALETTE = np.array([
    (200, 60, 60), (60, 200, 60), (60, 60, 200), (200, 200, 60),
    (200, 60, 200), (60, 200, 200), (230, 140, 40), (140, 40, 230),
    (40, 230, 140), (120, 120, 120), (230, 230, 230), (90, 50, 20),
], np.float32)

# (labeled, unlabeled, valid) images of each stage
STAGE1_SIZES = (1536, 7168, 1024)
STAGE2_SIZES = (128, 896, 1024)
# stage 1's cuts (chip_smoke.py's docstring, PERF.md §4): 3 epochs of 16
# steps, an evaluation and a checkpoint after each, and an EMA decay of 0.9
# so that the teacher evaluation reads moves in 48 steps (the JAX
# package's learning test does the same)
STAGE1_CUTS = {"EPOCHS": 3, "EVAL_STEP": 16, "FREQ_EVAL": 1,
               "EMA_DECAY": 0.9}
# stage 2's: one epoch of 2 steps
STAGE2_CUTS = {"EPOCHS": 1, "EVAL_STEP": 2}
CHUNK = 256  # images generated at a time


def class_images(classes: np.ndarray, size: int, noise: np.ndarray
                 ) -> np.ndarray:
    """``_class_image`` for each class of ``classes`` with the given noise
    (``(N, size, size, 3)``, already at std 18), as uint8 ``(N, size, size,
    3)``: the same expressions, batched."""
    n_pal = len(PALETTE)
    bases = np.stack([PALETTE[c % n_pal] * (0.75 + 0.5 * (c // n_pal))
                      for c in range(int(classes.max()) + 1)])
    img = np.broadcast_to(bases[classes][:, None, None, :],
                          (len(classes), size, size, 3)).copy()
    img += noise
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2) / (c * np.sqrt(2.0))
    img *= (1.0 - 0.35 * r)[None, ..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def make_images(rng: np.random.Generator, classes: np.ndarray, size: int
                ) -> np.ndarray:
    """Seeded images of ``classes``, in chunks, with float32 noise."""
    out = np.empty((len(classes), size, size, 3), np.uint8)
    for i in range(0, len(classes), CHUNK):
        cls = classes[i:i + CHUNK]
        noise = rng.standard_normal((len(cls), size, size, 3),
                                    dtype=np.float32) * np.float32(18.0)
        out[i:i + CHUNK] = class_images(cls, size, noise)
    return out


def array_loader(base, images: np.ndarray):
    """``base`` (``CanonicalLoader`` or ``EvalLoader``) reading row
    ``path`` of ``images`` in place of decoding a file."""
    class ArrayLoader(base):
        def decode(self, paths) -> np.ndarray:
            return images[np.asarray(paths, np.int64)]

    return ArrayLoader


def synthetic_data(config, sizes, seed: int):
    """What ``cli/learn.py::build_data`` returns for ``config``, from
    seeded images: labeled and valid classes in turn (balanced), unlabeled
    classes drawn at random, at the config's canonical size."""
    rng = np.random.default_rng(seed)
    n_cls = int(config.MODEL.NUM_CLASSES)
    n_lab, n_unl, n_valid = sizes
    size = canonical_size(config)
    split = {"labeled": np.arange(n_lab) % n_cls,
             "unlabeled": rng.integers(0, n_cls, n_unl),
             "valid": np.arange(n_valid) % n_cls}
    manifests = {k: Manifest(paths=np.arange(len(t)), targets=t)
                 for k, t in split.items()}
    manifests["unlabeled"].targets[:] = 0  # unlabeled rows carry no label
    images = {k: make_images(rng, t, size) for k, t in split.items()}
    bs = int(config.DATA.BATCH_SIZE)
    lab = array_loader(CanonicalLoader, images["labeled"])(
        manifests["labeled"], bs, size, seed=0)
    unl = array_loader(CanonicalLoader, images["unlabeled"])(
        manifests["unlabeled"], bs * int(config.DATA.MU), size, seed=1)
    valid = array_loader(EvalLoader, images["valid"])(
        manifests["valid"], bs, size)
    labeled = manifests["labeled"].targets
    return (lab, unl), valid, get_cls_num_list(labeled, n_cls), labeled


def flat_state(sd) -> dict:
    """A ``TrainState.state_dict()`` as one flat name → tensor dict."""
    out = {"step": torch.tensor(sd["step"])}
    for part in ("model", "ema"):
        out.update({f"{part}.{k}": v for k, v in sd[part].items()})
    out.update({f"adam.{n}.{k}": v for n, s in sd["optimizer"].items()
                for k, v in s.items()})
    return out


def stage_configs(save_dir: str, log_dir: str):
    """(stage 1, stage 2) configs: ``kaggle_semisupervised_real_3_1`` and
    ``..._real_3`` with their cuts, checkpoints under ``save_dir/stage1``
    and ``save_dir/stage2``, and the metric log under ``log_dir``."""
    return (path_c.train_config(path_c.REAL_3_1, TRAIN={
                **STAGE1_CUTS, "SAVE_CP": f"{save_dir}/stage1",
                "LOG_DIR": log_dir}),
            path_c.train_config(path_c.REAL_3, TRAIN={
                **STAGE2_CUTS, "SAVE_CP": f"{save_dir}/stage2",
                "LOG_DIR": log_dir}))
