"""DenseNet in PyTorch (port of ``endoscopy_tpu/models/densenet.py``).

The reference trains timm's ``densenet161``: growth 48, blocks (6, 12,
36, 24), 96 stem features, 2208 pooled features; ``densenet121`` is
growth 32, blocks (6, 12, 24, 16), 64 stem features. A dense layer is
BN → ReLU → 1x1 (``4 · growth``) → BN → ReLU → 3x3 (``growth``), its
output concatenated to its input along the channels; a transition is BN
→ ReLU → 1x1 (half the channels) → 2x2 average pool. The JAX module's
conventions are kept:

- every convolution is bias-free; BN has eps 1e-5, flax momentum 0.9
  (torch 0.1) and flax's biased running variance
  (``models/resnet.py::_flax_running_var``);
- flax's module names (``conv0``, ``norm0``, ``block{i}_layer{j}.norm1``,
  ``transition{i}.conv``, ``norm_final``), so a flax tree converts by
  joining its paths; ``ckpt/transfer.py`` maps timm's names onto them;
- the pooled features (the mean over the pixels of the last BN's ReLU)
  come back in float32.

Each layer concatenates anew, as the flax module does (XLA fuses the
copies there; eager PyTorch makes them): no checkpointing, since the JAX
model has none.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.resnet import (BatchNorm2d, _flax_running_var,
                                               conv2d)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = _bn(in_ch)
        self.conv1 = conv2d(in_ch, bn_size * growth_rate, 1)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = conv2d(bn_size * growth_rate, growth_rate, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm = _bn(in_ch)
        self.conv = conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)


class DenseNet(nn.Module):
    """Pooled float32 ``(B, num_features)`` features."""

    def __init__(self, growth_rate: int = 48,
                 block_config: Sequence[int] = (6, 12, 36, 24),
                 num_init_features: int = 96):
        super().__init__()
        self.conv0 = conv2d(3, num_init_features, 7, stride=2, padding=3)
        self.norm0 = _bn(num_init_features)
        self.pool0 = nn.MaxPool2d(3, stride=2, padding=1)
        features, self.names = num_init_features, []
        for i, num_layers in enumerate(block_config):
            for j in range(num_layers):
                name = f"block{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(features, growth_rate))
                self.names.append(name)
                features += growth_rate
            if i != len(block_config) - 1:
                name = f"transition{i + 1}"
                self.add_module(name, Transition(features, features // 2))
                self.names.append(name)
                features //= 2
        self.norm_final = _bn(features)
        self.num_features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _flax_running_var(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool0(F.relu(self.norm0(self.conv0(x))))
        for name in self.names:
            x = getattr(self, name)(x)
        return F.relu(self.norm_final(x)).mean(dim=(2, 3)).float()


def densenet161() -> DenseNet:
    return DenseNet(growth_rate=48, block_config=(6, 12, 36, 24),
                    num_init_features=96)


def densenet121() -> DenseNet:
    return DenseNet(growth_rate=32, block_config=(6, 12, 24, 16),
                    num_init_features=64)
