"""ResNet backbone in PyTorch (port of ``endoscopy_tpu/models/resnet.py``).

The plain ResNet-v1 form only (no SE, attention or SASA variants yet). The
JAX module's conventions are kept so weights carry across unchanged:

- the stage stride sits on the 3x3 ``conv2``;
- a downsample (1x1 conv with the stride, then BN) is built whenever the
  channels or the stride change, ``layer1.0`` included;
- the stem max-pool pads by 1;
- flax BN ``momentum=0.9`` is torch ``momentum=0.1``, ``eps=1e-5``;
- the pooled features come back in float32.

Torch is NCHW; on the card the caller moves the model and its input to
``channels_last``, the layout the JAX package (NHWC) computes in.
State-dict keys follow torchvision (``layer1.0.downsample.0``), which is
what ``ckpt/convert.py`` maps the flax tree onto.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 (stride) → 1x1 expand(x4) → +identity → ReLU."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = _bn(filters)
        self.conv3 = nn.Conv2d(filters, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                _bn(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet backbone producing pooled float32 ``(B, C)`` features;
    ``stage_sizes=(3, 4, 6, 3)`` is ResNet-50."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_filters: int = 64):
        super().__init__()
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        self.conv1 = nn.Conv2d(3, num_filters, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = _bn(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = num_filters
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = num_filters * (2 ** stage)
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, filters, stride))
                in_ch = filters * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_features = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3)).float()


def resnet50() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3))


def resnet_tiny() -> ResNet:
    """4-block, 8-filter ResNet for tests — not in the reference."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8)
