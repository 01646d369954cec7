"""Classification heads (port of ``endoscopy_tpu/models/heads.py``).

``build_head`` is the reference's factory: a simple linear head, or the
"complex" MLP in → in/4 → ReLU → Dropout(0.2) → BatchNorm1d → out; with
``use_bias=False`` the linear head is the margin losses' bias-free fc.

Heads run in float32 with autocast off, as the flax heads do (their
``dtype`` is float32) while the backbone computes in bf16. Their kernels
start from flax's initializer (``models/resnet.py::dense``).

The MLP head's dropout draws from its ``generator`` (the trainer sets its
own, on its device) unless ``keep_mask`` is set (the checks set the JAX
package's); in a process group the trainer sets ``rows``, the global
batch's row count and this rank's rows, and the head draws the global
batch's mask and keeps its rows. Its BN keeps flax's running variance
(``models/resnet.py::_flax_running_var``).

:func:`model_logits` takes the logits out of a model's output, for the
trainers' losses and evaluation and for serving.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from endoscopy_tpu_torch.models.resnet import (BatchNorm1d, _flax_running_var,
                                               dense)

KEEP = 0.8  # 1 - the MLP head's dropout rate


def model_logits(out):
    """Logits of a model's output: ``ModelwEmb`` returns ``(logits, fts,
    fts_low)``, the Conformer ``(conv, trans)`` (its conv head's), a plain
    classifier its logits."""
    if isinstance(out, tuple):
        return out[0]
    return out


class LinearHead(nn.Module):
    """Linear head (the reference's simple head); bias-free for the margin
    losses."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.fc = dense(in_features, out_features, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class MLPHead(nn.Module):
    """The 'complex' head: Dense(in/4) → ReLU → Dropout(0.2) →
    BatchNorm1d(momentum 0.9 in flax's terms, eps 1e-5) → Dense."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.fc1 = dense(in_features, in_features // 4)
        self.bn = BatchNorm1d(in_features // 4, eps=1e-5, momentum=0.1)
        self.fc2 = dense(in_features // 4, out_features)
        self.generator: Optional[torch.Generator] = None
        self.keep_mask: Optional[torch.Tensor] = None
        self.rows: Optional[Tuple[int, torch.Tensor]] = None

    def _after_dropout(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.bn(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(x))
        if not self.training:
            return self._after_dropout(x)
        keep_mask, g = self.keep_mask, self.generator
        if keep_mask is None:
            shape = x.shape if self.rows is None else (self.rows[0],
                                                       x.shape[1])
            keep_mask = torch.rand(shape, generator=g, device=(
                x.device if g is None else g.device)) < KEEP
            if self.rows is not None:
                keep_mask = keep_mask[self.rows[1]]
        x = torch.where(torch.as_tensor(keep_mask, device=x.device),
                        x / KEEP, torch.zeros_like(x))
        return _flax_running_var(self, self._after_dropout, x)


def build_head(in_features: int, out_features: int,
               is_complex: bool = False, use_bias: bool = True) -> nn.Module:
    """The reference's head factory."""
    if is_complex:
        return MLPHead(in_features, out_features)
    return LinearHead(in_features, out_features, use_bias)


class ClassifierHead(nn.Module):
    """backbone → pooled float32 features → head → logits."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fts = self.backbone(x)
        with torch.autocast(device_type=fts.device.type, enabled=False):
            return self.head(fts.float())
