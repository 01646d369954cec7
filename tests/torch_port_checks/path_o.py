"""Path O's config, data and fixture: ``cli/learn.py`` on JPEG files through
the native loader, and the card's decode against libjpeg's pixels.

- :data:`E2E` is ``configs/synthetic_tpu_e2e.yaml``'s fields written out
  (the card's machine has no PyYAML); ``native.py`` holds them against the
  file on the CPU. :data:`GENERATOR` is the generator's arguments in the
  YAML's header. :func:`config` adds the data paths, ``DATA.LOADER:
  native`` and the cuts.
- :data:`FIXTURE` is ``jpeg_fixture/``: the JPEGs of
  ``tools/torch_port/make_jpeg_fixture.py`` and the pixels libjpeg and cv2
  gave for them on the host that made them (``native.py`` holds those
  against the JAX package's decoders).

No JAX, pandas, cv2, PIL or PyYAML: ``chip_smoke.py`` imports it.
"""

from __future__ import annotations

import os
from pathlib import Path

from torch_port_checks import path_c

E2E = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": True, "MU": 7,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50"},
    "TRAIN": {"IS_SSL": True, "EPOCHS": 3, "EVAL_STEP": 64, "FREQ_EVAL": 3,
              "DTYPE": "bfloat16", "STEPS_PER_CALL": 8, "SAVE_CP": ""},
}
# make_synthetic_dataset's arguments in the YAML's header
GENERATOR = {"num_classes": 6, "n_train": 240, "n_valid": 48,
             "n_unlabeled": 640, "img_size": 160}
# O3's cuts: an evaluation and a checkpoint after each epoch (the YAML
# evaluates every third) and path D's EMA decay of 0.9, so that the
# teacher reads the 192 steps
CUTS = {"FREQ_EVAL": 1, "EMA_DECAY": 0.9}

FIXTURE = Path(__file__).resolve().parent / "jpeg_fixture"
# the fixture's JPEGs, in the order of expected.npz's rows (libjpeg_134)
FIXTURE_FILES = ("gen_420_q92_160.jpg", "cv2_444_q92_160.jpg",
                 "cv2_gray_q92_144.jpg", "odd_420_q92_161x127.jpg",
                 "cv2_q95_336.jpg")
# the rows of expected.npz's cv2_224: cv2's decode_canonical at 224 px
FIXTURE_CV2_FILES = ("gen_420_q92_160.jpg", "cv2_q95_336.jpg")
FIXTURE_PNG = "png_named.jpg"
FIXTURE_SIDE, FIXTURE_SERVE_SIDE = 134, 224


def config(root: str, save_dir: str = "", log_dir: str = "",
           base: dict = E2E, loader: str = "native", **sections):
    """``base`` (O3's fields by default) on the generator's files under
    ``root``, with ``DATA.LOADER`` ``loader``, the cuts, checkpoints under
    ``save_dir`` and the metric log under ``log_dir``; ``sections`` over
    them."""
    data = {"PATH": os.path.join(root, "labeled_images"),
            "ANNO": os.path.join(root, "anno.csv"),
            "UNANNO_PATH": os.path.join(root, "unlabeled_images"),
            "UNANNO": os.path.join(root, "unanno.csv"), "LOADER": loader,
            **sections.pop("DATA", {})}
    train = {**CUTS, "SAVE_CP": save_dir, "LOG_DIR": log_dir,
             **sections.pop("TRAIN", {})}
    return path_c.train_config(base, DATA=data, TRAIN=train, **sections)


def _segments(payload: bytes):
    """``(marker, start)`` of each marker segment of a JPEG after its SOI,
    up to and including its first SOS (``start`` at the segment's 0xFF)."""
    out, i = [], 2
    while i + 4 <= len(payload):
        assert payload[i] == 0xFF, i
        out.append((payload[i + 1], i))
        if payload[i + 1] == 0xDA:
            break
        i += 2 + int.from_bytes(payload[i + 2:i + 4], "big")
    return out


def broken_jpegs(payload: bytes) -> dict:
    """Copies of a baseline JPEG, each broken past the frame header that
    nvJPEG's header parse (``nvjpegGetImageInfo``) reads:

    - ``12_bit``: 12-bit samples in the frame header; nvJPEG's batched call
      refuses the batch (not supported), and the decode decodes its
      payloads again one at a time to find this one;
    - ``no_scan``: cut before its scan; the decode's own header walk leaves
      it out of the batch (bad JPEG);
    - ``half``: its first half; nvJPEG decodes what is there (status 0),
      as libjpeg does with a warning.
    """
    at = dict(_segments(payload))
    sof, sos = at[0xC0], at[0xDA]
    twelve = bytearray(payload)
    twelve[sof + 4] = 12  # the sample precision
    return {"12_bit": bytes(twelve), "no_scan": payload[:sos] + b"\xff\xd9",
            "half": payload[:len(payload) // 2]}
