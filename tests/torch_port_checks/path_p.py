"""Path P's branches: the supervised step's losses and views that no preset
reaches, on ``configs/kaggle_supervised_patho.yaml``'s fields.

``chip_smoke.py`` runs each branch's step on the card against the CPU by
path E3's method and times one bf16 step of each at the preset's width.
No JAX, pandas, cv2, PIL or PyYAML.

- ``margin``: ``MODEL.MARGIN: arcface``, the bias-free head and the
  angular-penalty loss on the backbone's features;
- ``focal``, ``ldam``, ``label_smoothing``, ``poly_bce``: the plain
  branch's loss swapped through :func:`loss_branch` (no preset sets a
  ``type_loss``; the JAX trainer has no option for it either);
- ``reproduce``: ``DATA.IS_REPROD``, the paper-reproduction train view
  (:func:`reproduce_step_view`).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.aug.views import reproduce_train_view
from endoscopy_tpu_torch.losses import (ce_loss, label_smoothing_loss,
                                        poly_bce_loss)
from endoscopy_tpu_torch.train import supervised
from torch_port_checks import path_e

# LDAM's class counts: the six classes of the preset, long-tailed
LDAM_CLS_NUM = [40, 20, 10, 6, 3, 1]

LOSSES = {
    "focal": lambda z, t, class_weights=None, reduction="mean": ce_loss(
        z, t, class_weights, reduction=reduction, type_loss="focal"),
    "ldam": lambda z, t, class_weights=None, reduction="mean": ce_loss(
        z, t, class_weights, reduction=reduction, type_loss="ldam",
        cls_num_list=LDAM_CLS_NUM),
    "label_smoothing": lambda z, t, class_weights=None, reduction="mean":
        label_smoothing_loss(z, t, 0.1, class_weights, reduction),
    "poly_bce": lambda z, t, class_weights=None, reduction="mean":
        poly_bce_loss(z, F.one_hot(t.long(), z.shape[-1]).to(z.dtype), 1.0,
                      reduction),
}
BRANCHES = ("margin", *LOSSES, "reproduce")


@contextlib.contextmanager
def loss_branch(name: str):
    """The supervised trainer's plain-branch loss replaced by ``name``'s
    (``LOSSES``) while the context is open; other branches as they are."""
    if name not in LOSSES:
        yield
        return
    with mock.patch.object(supervised, "ce_loss", LOSSES[name]):
        yield


def branch_config(name: str, **sizes):
    """Path E3's config (``path_e.step_config``: B=4, 112 px, float32) on
    the preset's fields, with the branch's field: ``MODEL.MARGIN`` or
    ``DATA.IS_REPROD``."""
    model = {"MARGIN": "arcface"} if name == "margin" else {}
    cfg = path_e.step_config(path_e.PATHO, False, **sizes, **model)
    cfg.DATA.IS_REPROD = name == "reproduce"
    return cfg


def reproduce_step_view(config, batch, seed: int, device: str
                        ) -> torch.Tensor:
    """The reproduce train view of ``batch``'s images on ``device`` in
    float32, drawn from a CPU generator seeded with ``seed`` (path E3's
    ``step_view`` for the ``reproduce`` branch)."""
    return reproduce_train_view(batch[0], int(config.DATA.IMG_SIZE),
                                torch.float32, torch.Generator().manual_seed(
                                    seed), device=device)


def step_view_fn(name: str):
    return reproduce_step_view if name == "reproduce" else path_e.step_view
