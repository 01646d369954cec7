"""EfficientNet in PyTorch (port of ``endoscopy_tpu/models/efficientnet.py``).

The reference's abnormal classifier and supervised presets use timm's
``efficientnet_b1``. MBConv: 1x1 expand (none at ratio 1) → depthwise kxk
→ squeeze-excite (``int(0.25 · input channels)``, convolutions with bias)
→ 1x1 project, SiLU activations, a residual when the stride is 1 and the
channels match. The JAX module's conventions are kept:

- BN eps 1e-3, flax momentum 0.9 (torch 0.1), flax's biased running
  variance (``models/resnet.py::_flax_running_var``);
- flax's initializer: the depthwise kernel's fan-in is ``k·k·1``, the SE
  biases start at 0 (``models/resnet.py::conv2d``);
- flax's module names (``stem_conv``, ``stage{S}_block{B}.dw_conv``,
  ``se_reduce``, ``head_bn``, ...), so a flax tree converts by joining its
  paths; ``ckpt/transfer.py`` maps timm 0.5.4's names onto them;
- the pooled features come back in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.resnet import (BatchNorm2d, _flax_running_var,
                                               conv2d)

# (expand_ratio, channels, repeats, stride, kernel): EfficientNet-B0's stages
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _round_channels(c: float, divisor: int = 8) -> int:
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-3, momentum=0.1)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_channels: int, expand_ratio: int,
                 strides: int, kernel: int, se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand_ratio
        self.expand_conv = self.expand_bn = None
        if expand_ratio != 1:
            self.expand_conv = conv2d(in_ch, mid, 1)
            self.expand_bn = _bn(mid)
        self.dw_conv = conv2d(mid, mid, kernel, stride=strides,
                              padding=kernel // 2, groups=mid)
        self.dw_bn = _bn(mid)
        se_ch = max(1, int(in_ch * se_ratio))
        self.se_reduce = conv2d(mid, se_ch, 1, bias=True)
        self.se_expand = conv2d(se_ch, mid, 1, bias=True)
        self.project_conv = conv2d(mid, out_channels, 1)
        self.project_bn = _bn(out_channels)
        self.residual = strides == 1 and in_ch == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_conv is not None:
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        s = self.se_expand(F.silu(self.se_reduce(y.mean((2, 3),
                                                        keepdim=True))))
        y = self.project_bn(self.project_conv(y * torch.sigmoid(s)))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Pooled float32 ``(B, head)`` features; the fields are the JAX
    module's."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 stages=_B0_STAGES, stem_channels: int = 32,
                 head_channels: int = 1280):
        super().__init__()
        stem = _round_channels(stem_channels * width_mult)
        self.stem_conv = conv2d(3, stem, 3, stride=2, padding=1)
        self.stem_bn = _bn(stem)
        in_ch, self.block_names = stem, []
        for si, (expand, channels, repeats, stride, kernel) in enumerate(stages):
            out_ch = _round_channels(channels * width_mult)
            for ri in range(int(math.ceil(repeats * depth_mult))):
                name = f"stage{si + 1}_block{ri + 1}"
                self.add_module(name, MBConv(in_ch, out_ch, expand,
                                             stride if ri == 0 else 1, kernel))
                self.block_names.append(name)
                in_ch = out_ch
        head = _round_channels(head_channels * width_mult)
        self.head_conv = conv2d(in_ch, head, 1)
        self.head_bn = _bn(head)
        self.num_features = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _flax_running_var(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(2, 3)).float()


def efficientnet_b0() -> EfficientNet:
    return EfficientNet(width_mult=1.0, depth_mult=1.0)


def efficientnet_b1() -> EfficientNet:
    return EfficientNet(width_mult=1.0, depth_mult=1.1)
