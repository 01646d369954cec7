"""Classification heads (port of ``endoscopy_tpu/models/heads.py`` subset)."""

from __future__ import annotations

import torch
from torch import nn


class LinearHead(nn.Module):
    """Linear head with bias (the reference's simple head)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.fc = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class ClassifierHead(nn.Module):
    """backbone → pooled float32 features → head → logits.

    The head runs in float32 with autocast off, as the flax head does
    (``LinearHead.dtype = float32``) while the backbone computes in bf16.
    """

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fts = self.backbone(x)
        with torch.autocast(device_type=fts.device.type, enabled=False):
            return self.head(fts.float())
