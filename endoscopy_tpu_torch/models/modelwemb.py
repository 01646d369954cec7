"""Backbone + classifier + L2-normalized projection head (port of
``endoscopy_tpu/models/modelwemb.py``).

``ModelwEmb`` returns ``(logits, fts, fts_low)``: the 'complex' MLP head's
logits (``fc``), the pooled backbone features, and a 2-layer projection to
``low_dim`` (Dense(3 · low_dim) → LeakyReLU(0.1) → Dense(low_dim) →
L2-normalize with eps 0, ``head_emb``). Both heads run in float32 with
autocast off, as the flax ones do. The supervised trainer's triplet
branch and the CoMatch trainer use it; EZBM is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.heads import MLPHead
from endoscopy_tpu_torch.models.resnet import dense


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0
                 ) -> torch.Tensor:
    """``x / sqrt(sum(x²) + eps)``."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


class ProjectionHead(nn.Module):
    """Dense(low_dim · k) → LeakyReLU(0.1) → Dense(low_dim) → L2-norm."""

    def __init__(self, in_features: int, low_dim: int = 128, k: int = 3):
        super().__init__()
        self.proj1 = dense(in_features, low_dim * k)
        self.proj2 = dense(low_dim * k, low_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.proj1(x), negative_slope=0.1)
        return l2_normalize(self.proj2(x))


class ModelwEmb(nn.Module):
    """The ``(logits, fts, fts_low)`` model; ``fc`` is the MLP head, whose
    dropout draws from its ``generator`` (see ``models/heads.py``)."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 low_dim: int = 128):
        super().__init__()
        self.backbone = backbone
        self.fc = MLPHead(backbone.num_features, num_classes)
        self.head_emb = ProjectionHead(backbone.num_features, low_dim)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        fts = self.features(x)
        with torch.autocast(device_type=fts.device.type, enabled=False):
            logits = self.fc(fts)
            return logits, fts, self.head_emb(fts)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled float32 backbone features."""
        return self.backbone(x).float()

    def classify_features(self, fts: torch.Tensor) -> torch.Tensor:
        """The MLP head on given features (EZBM's stage 2)."""
        with torch.autocast(device_type=fts.device.type, enabled=False):
            return self.fc(fts.float())
